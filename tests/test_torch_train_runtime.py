"""What surrounds the port's train step, against ``repro`` on the CPU: the
synthetic training stream (bit for bit), checkpoints (the reference's
layout and fault-tolerance tests, a checkpoint the reference wrote, bf16
leaves), int8 gradient compression (bit for bit), the tree utilities and
the fault-tolerant launcher on ``--device cpu`` with an injected
failure."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data.pipeline import SyntheticLMDataset as JaxDataset  # noqa: E402
from repro.training import checkpoint as JC  # noqa: E402
from repro.training import compression as JZ  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro.utils import tree as JU  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.training import compression as TZ  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402
from repro_torch.training.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.utils import tree as TU  # noqa: E402


# ----------------------------------------------------------------------------
# The synthetic training stream
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2.5-3b", "musicgen-large",
                                  "llama-3.2-vision-90b"])
def test_synthetic_batches_equal_reference_bit_for_bit(arch):
    """Token ids, embeddings and image embeddings, by index and by
    iteration, and the advancing ``index``."""
    ours = SyntheticLMDataset(get_smoke_config(arch), 24, 3, seed=5)
    ref = JaxDataset(jax_smoke(arch), 24, 3, seed=5)
    for idx in (0, 7, None, None):
        a, b = ours.batch(idx), ref.batch(idx)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        assert ours.index == ref.index
    it = iter(ours)
    np.testing.assert_array_equal(next(it)["labels"], ref.batch()["labels"])


def test_restart_resumes_data_position():
    """Exactly-once sample semantics across restart."""
    cfg = get_smoke_config("internlm2-1.8b")
    ds = SyntheticLMDataset(cfg, 16, 4, seed=3)
    b0, b1 = ds.batch(10), ds.batch(11)
    ds2 = SyntheticLMDataset(cfg, 16, 4, seed=3)
    ds2.index = 10
    np.testing.assert_array_equal(ds2.batch()["tokens"], b0["tokens"])
    np.testing.assert_array_equal(ds2.batch()["tokens"], b1["tokens"])
    assert ds2.index == 12


# ----------------------------------------------------------------------------
# Checkpoints
# ----------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    state = {"a": torch.arange(12.0).reshape(3, 4), "b": {"c": torch.ones(5)}}
    mgr.save(7, state, extra={"data_index": 123})
    restored, step, extra = mgr.restore(state)
    assert step == 7 and extra["data_index"] == 123
    for x, y in zip(TU.tree_leaves(state), TU.tree_leaves(restored)):
        assert torch.equal(x, y)


def test_checkpoint_keep_last_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_write=False)
    state = {"w": torch.zeros(2)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((2,), float(s))})
    assert mgr.list_steps() == [3, 4]
    restored, step, _ = mgr.restore(state)
    assert step == 4 and float(restored["w"][0]) == 4.0


def test_incomplete_checkpoint_never_latest(tmp_path):
    """Crash-mid-write must not corrupt restore (manifest commits last)."""
    mgr = CheckpointManager(str(tmp_path), keep_last=3, async_write=False)
    state = {"w": torch.ones(2)}
    mgr.save(1, state)
    os.makedirs(tmp_path / "step_00000002")
    np.save(tmp_path / "step_00000002" / "leaf_0.npy", np.zeros(2))
    os.makedirs(tmp_path / "step_00000003.tmp")
    assert mgr.latest_step() == 1
    _, step, _ = mgr.restore(state)
    assert step == 1


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    w = torch.ones((1000, 100))
    mgr.save(5, {"w": w})
    w.add_(1.0)                  # the snapshot is a copy, taken at save
    mgr.wait()
    assert mgr.latest_step() == 5
    assert float(mgr.restore({"w": w})[0]["w"].max()) == 1.0


def test_checkpoint_bf16_leaves_and_the_optimizer_state(tmp_path):
    """bf16 leaves are written as their uint16 bits with "bfloat16" in the
    manifest and come back bit for bit; the (params, AdamWState) tuple of
    the launcher round-trips with its leaf paths."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
              "n": torch.randn(3, generator=g)}
    opt = TO.adamw_init(params, TO.AdamWConfig())
    opt = opt._replace(step=opt.step + 9)
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(9, (params, opt))
    man = json.loads((tmp_path / "step_00000009" / "manifest.json").read_text())
    assert [m["name"] for m in man["leaves"]] == [
        "0/n", "0/w", "1/step", "1/m/n", "1/m/w", "1/v/n", "1/v/w"]
    assert [m["dtype"] for m in man["leaves"]][:3] == [
        "float32", "bfloat16", "int32"]
    assert np.load(tmp_path / "step_00000009" / "leaf_1.npy").dtype == \
        np.uint16
    like = TU.tree_map(torch.zeros_like, (params, opt))
    (p2, o2), step, _ = mgr.restore(like)
    assert step == 9 and int(o2.step) == 9 and isinstance(o2, TO.AdamWState)
    assert p2["w"].dtype == torch.bfloat16
    assert all(torch.equal(a, b) for a, b in
               zip(TU.tree_leaves((params, opt)), TU.tree_leaves((p2, o2))))


def test_restores_a_checkpoint_the_reference_wrote(tmp_path):
    """The reference's CheckpointManager writes (params, AdamWState) of
    fp32 leaves; the port restores it into its own tree, leaf for leaf,
    with the extra metadata; and the reference restores the port's."""
    rng = np.random.default_rng(0)
    p = {"embed": rng.standard_normal((6, 4)).astype(np.float32),
         "groups": {"w": rng.standard_normal((2, 4, 4)).astype(np.float32)}}
    pj = jax.tree.map(jnp.asarray, p)
    oj = JO.adamw_init(pj, JO.AdamWConfig())
    oj = oj._replace(step=oj.step + 3,
                     m=jax.tree.map(lambda a: a + 0.5, oj.m))
    JC.CheckpointManager(str(tmp_path / "ref"), async_write=False).save(
        3, (pj, oj), extra={"data_index": 17})
    pt = TU.tree_map(torch.from_numpy, p)
    like = (TU.tree_map(torch.zeros_like, pt),
            TO.adamw_init(pt, TO.AdamWConfig()))
    (p2, o2), step, extra = CheckpointManager(str(tmp_path / "ref")).restore(
        like)
    assert step == 3 and extra == {"data_index": 17} and int(o2.step) == 3
    for a, b in zip(jax.tree.leaves((pj, oj)), TU.tree_leaves((p2, o2))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(
        4, (p2, o2), extra={"data_index": 18})
    (pj3, oj3), step, extra = JC.CheckpointManager(
        str(tmp_path / "port")).restore((pj, oj))
    assert step == 4 and extra == {"data_index": 18}
    for a, b in zip(jax.tree.leaves((pj3, oj3)), jax.tree.leaves((pj, oj))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ----------------------------------------------------------------------------
# Gradient compression
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1000, 2048, 5000])
def test_int8_quantization_equals_reference(n):
    """Blocks, scales and int8 codes bit for bit, and the dequantised
    values; the error bound of the reference's test."""
    x = np.random.default_rng(n).normal(0, 3.0, (n,)).astype(np.float32)
    qj, sj = JZ.quantize_int8(jnp.asarray(x))
    qt, st = TZ.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and tuple(qt.shape) == tuple(qj.shape)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    deq = TZ.dequantize_int8(qt, st, x.shape)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(JZ.dequantize_int8(qj, sj, x.shape)))
    err = np.abs(deq.numpy() - x)
    assert err.max() <= float(np.abs(x).max()) / 127.0 + 1e-6


def test_error_feedback_matches_reference():
    """Twenty steps of compress/decompress with error feedback on a tree:
    codes, scales and carried errors equal to the reference's; the running
    sum of the dequantised grads tracks the true sum."""
    rng = np.random.default_rng(1)
    ej = et = None
    acc_q, acc_t = np.zeros(513), np.zeros(513)
    for _ in range(20):
        g = {"g": rng.normal(0, 1, (513,)).astype(np.float32),
             "h": {"k": rng.normal(0, 2, (3, 700)).astype(np.float32)}}
        gj = jax.tree.map(jnp.asarray, g)
        gt = TU.tree_map(torch.from_numpy, g)
        qj, sj, ej = JZ.compress_tree(gj, ej)
        qt, st, et = TZ.compress_tree(gt, et)
        for a, b in zip(jax.tree.leaves((qj, sj, ej)),
                        TU.tree_leaves((qt, st, et))):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        deq = TZ.decompress_tree(qt, st, gt)
        np.testing.assert_array_equal(
            deq["h"]["k"].numpy(),
            np.asarray(JZ.decompress_tree(qj, sj, gj)["h"]["k"]))
        acc_q += deq["g"].numpy()
        acc_t += g["g"]
    assert np.abs(acc_q - acc_t).max() < 0.1


# ----------------------------------------------------------------------------
# Tree utilities
# ----------------------------------------------------------------------------

def test_tree_utilities_match_reference():
    rng = np.random.default_rng(2)
    p = {"b": rng.standard_normal((3, 2)).astype(np.float32),
         "a": {"z": np.arange(5, dtype=np.int32),
               "y": rng.standard_normal(4).astype(np.float32)}}
    pj = jax.tree.map(jnp.asarray, p)
    tree_j = (pj, JO.adamw_init(pj, JO.AdamWConfig()))
    pt = TU.tree_map(torch.from_numpy, p)
    tree_t = (pt, TO.adamw_init(pt, TO.AdamWConfig()))
    paths_j = jax.tree.leaves(JU.tree_map_with_path(lambda s, x: s, tree_j))
    paths_t = TU.tree_leaves(TU.tree_map_with_path(lambda s, x: s, tree_t))
    assert paths_t == paths_j
    assert TU.tree_size_bytes(tree_t) == JU.tree_size_bytes(tree_j)
    assert TU.tree_num_params(tree_t) == JU.tree_num_params(tree_j)
    assert TU.tree_allclose(pt, TU.tree_map(lambda t: t + 1e-7, pt))
    assert not TU.tree_allclose(pt, TU.tree_map(lambda t: t + 1, pt))
    half = TU.tree_cast(pt, torch.bfloat16)
    assert {t.dtype for t in TU.tree_leaves(half)} == {torch.bfloat16}
    back = TU.tree_unflatten(tree_t, TU.tree_leaves(tree_t))
    assert isinstance(back[1], TO.AdamWState)
    assert TU.tree_size_bytes(back) == TU.tree_size_bytes(tree_t)


# ----------------------------------------------------------------------------
# The launcher
# ----------------------------------------------------------------------------

def test_launcher_restarts_from_the_latest_checkpoint(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` on the CPU: 8 steps of
    qwen2.5-3b's smoke config at 2 layers, a checkpoint every 2 steps, a
    failure injected at step 5 of the first attempt; the second attempt
    restores step 4 at data index 4 and runs to the end, and keeps the
    last three checkpoints."""
    out = launcher.main([
        "--arch", "qwen2.5-3b", "--smoke", "--set", "num_layers=2",
        "--device", "cpu", "--steps", "8", "--global-batch", "4",
        "--seq-len", "32", "--ckpt-every", "2", "--simulate-failure-at", "5",
        "--ckpt-dir", str(tmp_path), "--lr", "1e-2"])
    assert out["attempts"] == 2 and out["restored"] == [(4, 4)]
    assert sorted(out["losses"]) == list(range(8))
    assert all(np.isfinite(v) for v in out["losses"].values())
    assert CheckpointManager(str(tmp_path)).list_steps() == [4, 6, 8]
    text = capsys.readouterr().out
    assert "injected failure" in text and "restored step 4" in text
    assert text.rstrip().endswith("[train] done")


def test_launcher_needs_a_card_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])
