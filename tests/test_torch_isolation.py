"""The PyTorch port stands alone: every module imports with jax and triton blocked
and loads nothing of the JAX package; its entry points refuse ``device="cuda"``
when no card is visible instead of running on the CPU."""
import runpy
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"
SERVE_EXAMPLE = SRC.parent / "examples" / "serve_torch.py"
TRAIN_EXAMPLE = SRC.parent / "examples" / "train_lm_torch.py"
#: the subprocesses' environment: two threads each, so that under the test
#: runner's parallel workers a child does not spin on every core of the machine
_ENV = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"}


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
                     "models.frontends", "runtime.supervisor", "serving.server",
                     "training.optimizer", "training.compression", "training.trainer",
                     "checkpoint.manager", "runtime.straggler", "launch.train",
                     "launch.mesh", "sharding.planner", "sharding.collectives",
                     "runtime.elastic", "training.layout"):
            assert "repro_torch." + name in names, name
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_ENV, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_serve_example_runs_on_the_cpu_without_jax():
    """examples/serve_torch.py serves the smoke config through two replicas on the
    CPU with jax blocked, loading nothing of the JAX package."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "jaxlib", "triton"):
            sys.modules[name] = None
        sys.argv = ["serve_torch.py", "--smoke", "--device", "cpu", "--quant", "int8",
                    "--replicas", "2", "--cache-layout", "paged", "--shared-prefix", "16",
                    "--n-requests", "4", "--max-new", "3"]
        runpy.run_path({str(SERVE_EXAMPLE)!r}, run_name="__main__")
        leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count(" toks [length] replica=") == 4, out.stdout
    assert '"completed": 4' in out.stdout and '"affinity_hits": 3' in out.stdout


def test_train_example_runs_on_the_cpu_without_jax():
    """examples/train_lm_torch.py trains the smoke config through a failure and a
    restart on the CPU with jax blocked, loading nothing of the JAX package."""
    code = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "jaxlib", "triton"):
            sys.modules[name] = None
        out = runpy.run_path({str(TRAIN_EXAMPLE)!r})["main"](["--device", "cpu", "--steps", "8"])
        leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        assert out["restarts"] == 1 and len(out["ppl"]) == 3, out
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=_ENV, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "after 1 restart(s)" in out.stdout, out.stdout


def test_sharded_launcher_runs_without_jax(tmp_path):
    """``torchrun --nproc_per_node 2 -m repro_torch.launch.serve --mesh 1,2 --device
    cpu`` serves the smoke config on a gloo world of two ranks with jax and the JAX
    package made unimportable (stub packages that raise first on the path)."""
    for name in ("jax", "jaxlib", "repro"):
        (tmp_path / name).mkdir()
        (tmp_path / name / "__init__.py").write_text(f"raise ImportError('{name} blocked')\n")
    torchrun = Path(sys.executable).with_name("torchrun")
    out = subprocess.run(
        [str(torchrun), "--standalone", "--nproc_per_node", "2", "-m", "repro_torch.launch.serve",
         "--arch", "starcoder2-7b", "--smoke", "--mesh", "1,2", "--device", "cpu",
         "--quant", "int8", "--path", "fused-int8", "--kv-cache", "int8",
         "--n-requests", "3", "--max-new", "3"],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": f"{tmp_path}:{SRC}", "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("served 3 requests") == 1, out.stdout      # rank 0 reports
    assert "mesh={'data': 1, 'model': 2} tier=tp_full" in out.stdout


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
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "starcoder2-7b", "--smoke", "--mesh", "1,2"])
    from repro_torch.launch.mesh import make_debug_mesh
    with pytest.raises(RuntimeError, match="cuda"):            # sharded: default cuda too
        ServeEngine(cfg, params, config=EngineConfig(batch_size=1, max_len=16),
                    mesh=make_debug_mesh(1, 1))
    with pytest.raises(RuntimeError, match="need 2 processes"):
        make_debug_mesh(1, 2)
    from repro_torch.serving.server import AsyncServer
    with pytest.raises(RuntimeError, match="cuda"):
        AsyncServer(cfg, params, config=EngineConfig(batch_size=1, max_len=16))
    example = runpy.run_path(str(SERVE_EXAMPLE))
    with pytest.raises(RuntimeError, match="cuda"):
        example["main"](["--smoke"])                           # default device: cuda
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "mamba2-130m", "--smoke"])        # default device: cuda
    with pytest.raises(RuntimeError, match="cuda"):
        train.main(["--arch", "mamba2-130m", "--smoke", "--device", "cuda"])
    with pytest.raises(RuntimeError, match="cuda"):
        runpy.run_path(str(TRAIN_EXAMPLE))["main"]([])          # default device: cuda


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises; nothing falls back to the plain versions."""
    from repro_torch.kernels import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
