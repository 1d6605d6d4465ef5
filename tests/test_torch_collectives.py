"""The port's compressed cross-rank mean
(``repro_torch.distributed.collectives.compressed_mean_rows``) on a gloo
group of four CPU processes, against the JAX package's ``shard_map``
version on a 4-device CPU mesh (its own process, as
``tests/test_collectives.py`` runs it).

Each rank's row and the reference's global array come from one seeded
``numpy`` draw.  The int8 codes are the same on both sides (``torch.round``
and ``jnp.round`` both round half to even); the fp32 mean over the sources
may sum in another order, so after the bf16 gather the two agree within one
bf16 ulp of each element.  Both are within the reference test's bound of
the fp32 mean.  The workers record the dtypes they hand the two
``torch.distributed`` calls: int8 codes (and fp32 scales, one a row) on the
all-to-all, bf16 on the gather."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")
WORLD = 4
TIMEOUT = 180

_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import compressed_mean_rows

    rank, world, size, seed, out = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), int(sys.argv[4]),
                                    sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(out + "/store",
                                                         world),
                            rank=rank, world_size=world)
    wire = []
    for name in ("all_to_all_single", "all_gather_into_tensor"):
        def recorded(output, input, *a, _orig=getattr(dist, name),
                     _name=name, **kw):
            wire.append([_name, str(input.dtype), str(output.dtype)])
            return _orig(output, input, *a, **kw)
        setattr(dist, name, recorded)
    g = np.random.default_rng(seed).normal(0, 1.0, (world, size))
    try:
        mean = compressed_mean_rows(torch.from_numpy(
            g[rank].astype(np.float32)))
    finally:
        dist.destroy_process_group()
    np.save(f"{out}/rank{rank}.npy", mean.numpy())
    with open(f"{out}/wire{rank}.json", "w") as f:
        json.dump(wire, f)
""")

_REFERENCE = textwrap.dedent("""
    import sys
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.distributed.collectives import compressed_mean_rows

    world, size, seed, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    mesh = jax.make_mesh((world,), ("data",))
    g = np.random.default_rng(seed).normal(0, 1.0, (world, size)).astype(
        np.float32)
    gd = jax.device_put(g, NamedSharding(mesh, P("data")))
    np.save(out + "/reference.npy",
            np.asarray(compressed_mean_rows(gd, mesh, "data")))
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), JAX_PLATFORMS="cpu")
    env.update(extra)
    return env


def _run(procs):
    """Wait for every process, within TIMEOUT; kill the rest on a failure."""
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("size,seed", [(WORLD * 512, 0), (WORLD * 128 * 3, 7)])
def test_compressed_mean_on_four_gloo_ranks_equals_reference(tmp_path, size,
                                                             seed):
    out = str(tmp_path)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(WORLD), str(size),
         str(seed), out], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    procs.append(subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(WORLD), str(size), str(seed),
         out], env=_env(XLA_FLAGS="--xla_force_host_platform_device_count="
                        f"{WORLD}"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    _run(procs)
    rows = np.stack([np.load(tmp_path / f"rank{r}.npy") for r in range(WORLD)])
    ref = np.load(tmp_path / "reference.npy")
    assert rows.dtype == np.float32 and rows.shape == (WORLD, size)
    assert ref.shape == (WORLD, size)
    # every rank holds the same mean
    assert (rows == rows[:1]).all()
    # within one bf16 ulp of the reference's, element by element: the
    # values are bf16 numbers, so the ulp is 2^-7 of the larger's binade
    binade = np.exp2(np.floor(np.log2(np.maximum(np.abs(rows), np.abs(ref)))))
    assert (np.abs(rows - ref) <= binade * 2.0 ** -7).all()
    # the reference test's bound on the gap to the fp32 mean
    g = np.random.default_rng(seed).normal(0, 1.0, (WORLD, size)).astype(
        np.float32)
    bound = np.abs(g).max() / 127.0 + 0.02
    assert np.abs(rows[0] - g.mean(axis=0)).max() < bound
    assert np.abs(ref[0] - g.mean(axis=0)).max() < bound
    # the wire: int8 codes and fp32 scales on the all-to-all, bf16 gathered
    for r in range(WORLD):
        wire = json.loads((tmp_path / f"wire{r}.json").read_text())
        assert wire == [["all_to_all_single", "torch.int8", "torch.int8"],
                        ["all_to_all_single", "torch.float32",
                         "torch.float32"],
                        ["all_gather_into_tensor", "torch.bfloat16",
                         "torch.bfloat16"]], wire


def test_compressed_mean_on_one_rank(tmp_path):
    """A group of one: the mean is the row itself, through the int8 codes
    (half a scale) and the bf16 gather (half a bf16 ulp)."""
    import torch.distributed as dist
    from repro_torch.distributed import compressed_mean_rows
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        one = torch.arange(256, dtype=torch.float32)
        got = compressed_mean_rows(one)
        assert got.dtype == torch.float32 and got.shape == (256,)
        assert (got - one).abs().max() <= 255 / 127 / 2 + 255 * 2 ** -8
    finally:
        dist.destroy_process_group()
