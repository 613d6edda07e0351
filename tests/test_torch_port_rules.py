"""Rules the PyTorch port keeps: it imports neither JAX nor the JAX
package, its entry points refuse to run on the CPU unasked, and its
CUDA-only tests skip cleanly where there is no card."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "horovod_tpu")


def _port_files():
    files = sorted((REPO / "horovod_tpu_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, pkgutil, importlib, horovod_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "assert not bad, bad\n"
            "import horovod_tpu_torch._cuda as c\n"
            "assert c._lib is None  # nothing built or loaded on import\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=60)


def test_entry_points_raise_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerConfig, TransformerLM
    with pytest.raises(RuntimeError, match="device='cpu'"):
        hvd.init()
    assert not hvd.initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(TransformerConfig(num_layers=1, vocab_size=8,
                                        num_heads=1, head_dim=16))


def test_cuda_tests_skip_cleanly_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tests run instead")
    env = dict(os.environ, PYTHONPATH=str(REPO),
               PYTEST_DISABLE_PLUGIN_AUTOLOAD="1")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-rs", "tests/test_torch_cuda.py"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "passed" not in res.stdout and "failed" not in res.stdout
    assert "skipped" in res.stdout and "needs a CUDA device" in res.stdout


def test_chip_smoke_fails_without_the_card_or_the_package(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
