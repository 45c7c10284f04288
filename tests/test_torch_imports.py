"""Import hygiene and device rules of the PyTorch port.

The port (`src/repro_torch/**`, `chip_smoke.py`) imports torch, numpy and
the standard library only — never jax and never the reference package —
and its entry points refuse to run on the CPU unless asked to."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.bridge, repro_torch.serve, repro_torch.launch.serve\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref, repro_torch.kernels._build\n"
        "import repro_torch.kernels.flashd_varlen, repro_torch.runtime, repro_torch.runtime.kvcache\n"
        "import repro_torch.configs, repro_torch.core\n"
        "import repro_torch.optim, repro_torch.train, repro_torch.data, repro_torch.tree\n"
        "import repro_torch.runtime.checkpoint, repro_torch.runtime.resilience\n"
        "import repro_torch.launch.train, repro_torch.kernels.flashd_bwd\n"
        "import repro_torch.kernels.fa2_fwd, repro_torch.distributed.sharding\n"
        "import repro_torch.runtime.quant, repro_torch.serve.speculative, repro_torch.serve.engine\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_importing_builds_nothing():
    """Kernels build on first launch, never at import (there is no nvcc here)."""
    from repro_torch.kernels import _build

    assert set(_build.SOURCES) == {"flashd_fwd", "flashd_decode", "flashd_varlen", "flashd_bwd",
                                   "fa2_fwd"}
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").exists()
    assert "-gencode" in _build.NVCC_FLAGS and "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS


def test_tf32_is_off_where_the_port_starts():
    import repro_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.transformer import init_decode_cache, init_lm
    from repro_torch.serve import Engine, ServeConfig

    cfg = get_smoke_config("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_decode_cache(1, 8, cfg)
    params = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(params, cfg, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--requests", "1"])
    from repro_torch.launch import train as launch_train
    from repro_torch.train import TrainConfig, init_train_state, train_resilient

    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, TrainConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_resilient(ckpt_dir="unused", model_cfg=cfg, train_cfg=TrainConfig(), data=None,
                        total_steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_port_files_cover_the_new_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("runtime/__init__.py", "runtime/kvcache.py", "kernels/flashd_varlen.py",
                "runtime/checkpoint.py", "runtime/resilience.py", "optim/adamw.py",
                "optim/schedule.py", "data/pipeline.py", "train/train_step.py",
                "train/resilient.py", "launch/train.py", "kernels/flashd_bwd.py",
                "kernels/fa2_fwd.py", "tree.py"):
        assert f"src/repro_torch/{mod}" in names


@pytest.mark.parametrize("flags", [["--kv-layout", "paged", "--no-prefix-cache"],
                                   ["--step-mode", "mixed", "--no-prefix-cache",
                                    "--prefill-chunk", "4", "--page-size", "8"]])
def test_launcher_runs_the_paged_loops_on_the_cpu(capsys, flags):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "9", "--max-new-tokens", "4",
                            "--max-batch", "2", *flags])
    out = capsys.readouterr().out
    assert rc == 0
    assert "time-to-first-token" in out and "kv pool" in out
    assert out.count("request ") >= 3


def test_launcher_runs_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                            "--requests", "3", "--prompt-len", "5", "--max-new-tokens", "4",
                            "--max-batch", "2"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "tok/s" in out and "time-to-first-token" in out
    assert out.count("request ") >= 3
