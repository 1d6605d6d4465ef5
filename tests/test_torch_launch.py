"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU at
smoke size: every request is served, the controller leaves its warmup and
its recommendations drive the batches, and the launcher, like every entry
point of the port, runs on CUDA unless the caller asks for the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as S  # noqa: E402


@pytest.fixture(scope="module")
def summary():
    return S.serve("qwen2.5-3b", smoke=True, requests=12, device="cpu")


def test_serve_serves_every_request_and_leaves_warmup(summary):
    assert sum(summary["batch_sizes"]) == 12
    assert len(summary["waits"]) == 12 and np.all(summary["waits"] >= 0)
    rec = summary["recommendation"]
    assert rec.n_max is not None and rec.details.get("reason") != "warmup"
    # warmup batches run padded with no limit; once the controller has 8
    # completions it picks elastic (the engine exits early) and a limit
    n = len(summary["batch_sizes"])
    assert summary["policies"][0] == "dynamic" and summary["n_max"][0] is None
    assert summary["policies"][-1] == rec.policy == "elastic"
    assert summary["n_max"][-1] is not None
    prefills = [e for e in summary["step_log"] if e["kind"] == "prefill"]
    assert len(prefills) == n
    assert all(e["seq"] % 16 == 0 for e in prefills)      # prompt_bucket=16


def test_serve_clips_outputs_at_the_recommended_limit(summary):
    """Each request gets min(its target, its batch's n_max) tokens."""
    limits = np.repeat([np.inf if n is None else n for n in summary["n_max"]],
                       summary["batch_sizes"])
    produced = np.asarray(summary["produced"])
    assert len(produced) == 12 and np.all(produced >= 1)
    assert np.all(produced <= limits)


def test_serve_needs_a_gpu_unless_the_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.serve("qwen2.5-3b", smoke=True, requests=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.main(["--arch", "qwen2.5-3b", "--smoke", "--requests", "2"])


def test_serve_rejects_unknown_policy():
    with pytest.raises(ValueError, match="policy"):
        S.serve("qwen2.5-3b", smoke=True, policy="fixed", device="cpu")


def test_main_runs_the_cli_on_the_cpu(capsys):
    S.main(["--arch", "qwen2.5-3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--policy", "dynamic"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) >= 2 and out[-2].startswith("[serve] t=")
    assert "served=3/3" in out[-2] and "policy=dynamic" in out[-2]
    assert out[-1].startswith("[serve] mean queue wait")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "internlm2-1.8b", "yi-9b",
                                  "gemma-7b"])
def test_main_runs_each_dense_arch_on_the_cpu(capsys, arch):
    """``python -m repro_torch.launch.serve --arch <id> --smoke --device
    cpu`` for every ported dense family."""
    S.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert "served=3/3" in out[-2]
    assert out[-1].startswith("[serve] mean queue wait")


def test_launcher_config_is_the_reference_one():
    """The launcher serves the reference launcher's smoke config, with the
    cache in the model's dtype (fp32 at smoke size, the reference
    engine's default)."""
    from repro.configs import get_smoke_config as jax_smoke
    from repro_torch.configs import get_smoke_config
    assert dataclasses.asdict(get_smoke_config("qwen2.5-3b")) == \
        dataclasses.asdict(jax_smoke("qwen2.5-3b"))
    assert get_smoke_config("qwen2.5-3b").dtype == "float32"
