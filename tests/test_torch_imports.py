"""Import hygiene of the port: ``src/repro_torch`` and ``chip_smoke.py``
import neither JAX nor the reference package, and the engine does not fall
back to the CPU when no GPU is found, nor do the weight bridge and the
param and cache initializers."""

import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_found():
    assert len(PORT_FILES) > 10
    port = ROOT / "src" / "repro_torch"
    for rel in ("serving/engine.py", "launch/serve.py", "core/control.py",
                "core/bulk.py", "core/policy_opt.py", "core/impatience.py",
                "core/mg1.py", "core/latency_model.py",
                "core/distributions.py", "kernels/flash_attention/ops.py",
                "kernels/rmsnorm/ops.py", "core/simulate.py",
                "core/fastsim.py", "kernels/batch_scan/ops.py",
                "kernels/impatience_scan/ops.py", "core/predictors.py",
                "core/traffic.py", "core/faults.py", "core/fleet.py",
                "serving/router.py", "kernels/backlog_scan/ops.py",
                "core/sessions.py", "serving/resilience.py",
                "core/memory.py", "kernels/tandem_scan/ops.py",
                "kernels/tandem_scan/ref.py",
                "kernels/tandem_scan/csrc/tandem_scan.cu",
                "models/mamba.py", "configs/mamba2_2_7b.py",
                "configs/jamba_1_5_large_398b.py", "kernels/ssd_scan/ops.py",
                "kernels/ssd_scan/ref.py", "kernels/ssd_scan/csrc/ssd_scan.cu",
                "kernels/ssd_scan/csrc/ssd_scan_bwd.cu"):
        assert port / rel in PORT_FILES or (
            rel.endswith(".cu") and (port / rel).is_file()), rel


def test_every_kernel_source_is_registered():
    """Each CUDA source of the port is built by ``kernels.build`` and has a
    launch counter that ``reset_launches`` zeroes."""
    from repro_torch import kernels as K
    sources = sorted((ROOT / "src" / "repro_torch" / "kernels").rglob("*.cu"))
    assert sorted(K.SOURCES.values()) == sources and len(sources) == 15
    K.reset_launches()
    assert {K.LAUNCHES[name] for name in K.SOURCES} == {0}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_without_gpu_raises_unless_cpu_is_asked(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import Engine, EngineConfig
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cfg, EngineConfig())
    assert Engine(cfg, EngineConfig(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "init_cache"])
def test_param_and_cache_entry_points_default_to_gpu(entry, monkeypatch):
    """The weight bridge and the param/cache initializers, like the engine,
    run on CUDA unless the caller passes ``device="cpu"``."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_cache, param_specs
    from repro_torch.models.params import (
        init_params, params_from_numpy, tree_leaves)
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), num_layers=2)
    gen = torch.Generator().manual_seed(0)
    call = {
        "init_params": lambda **kw: init_params(param_specs(cfg), gen, **kw),
        "params_from_numpy": lambda **kw: params_from_numpy(
            {"a": {"b": np.zeros((2, 3), np.float32)}}, **kw),
        "init_cache": lambda **kw: init_cache(cfg, 2, 16, torch.float32, **kw),
    }[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    leaves = tree_leaves(call(device="cpu"))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
