"""The PyTorch port stands alone: every module imports with jax and triton blocked
and loads nothing of the JAX package; its entry points refuse ``device="cuda"``
when no card is visible instead of running on the CPU."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"


def test_imports_without_jax_triton_or_repro():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "triton"):
            sys.modules[name] = None        # any import of them raises ImportError
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        for name in ("launch.serve", "kernels.ops", "core.kernel_analysis", "core.smoothquant",
                     "core.awq", "core.quantizers", "core.qlinear", "models.quantize",
                     "models.frontends"):
            assert "repro_torch." + name in names, name
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the no-card refusal cannot be exercised")


def test_entry_points_refuse_cuda_without_a_card():
    _no_card()
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.device import resolve_device
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import ServeEngine

    cfg = get("starcoder2-7b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_params(torch.Generator(), cfg, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        M.init_cache(cfg, 2, 16, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_numpy({"w": np.zeros(3, np.float32)}, device="cuda")
    params = M.init_params(torch.Generator(), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params, config=EngineConfig(batch_size=1, max_len=16))
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "starcoder2-7b", "--smoke"])     # default device: cuda


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to the plain versions."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
