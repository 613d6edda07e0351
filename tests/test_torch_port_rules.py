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


IMPORT_CODE = (
    "import sys, pkgutil, importlib, horovod_tpu_torch as p\n"
    "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
    "    importlib.import_module(m.name)\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in "
    f"{FORBIDDEN!r}]\n"
    "assert not bad, bad\n"
    "import horovod_tpu_torch._cuda as c\n"
    "assert c._lib is None  # nothing built or loaded on import\n")


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """The fresh interpreters this file's checks run, started at once by
    the first test that asks (each spends seconds starting and
    importing); ``result(name, timeout)`` waits for one and gives its
    (return code, stdout, stderr). Where there is a card, the checks of
    its absence are not started (their tests skip)."""
    out = tmp_path_factory.mktemp("port_rules")
    shutil.copy(REPO / "chip_smoke.py", out / "chip_smoke.py")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    specs = {"imports": ([sys.executable, "-c", IMPORT_CODE], REPO, env),
             "chip_smoke": ([sys.executable, "chip_smoke.py"], out,
                            {k: v for k, v in os.environ.items()
                             if k != "PYTHONPATH"})}
    if not torch.cuda.is_available():
        specs["bench"] = ([sys.executable, "-m", "horovod_tpu_torch.bench"],
                          REPO, env)
        specs["cuda_tests"] = (
            [sys.executable, "-m", "pytest", "--noconftest", "-q",
             "-p", "no:cacheprovider", "-rs", "tests/test_torch_cuda.py"],
            REPO, dict(env, PYTEST_DISABLE_PLUGIN_AUTOLOAD="1"))
    procs = {}
    for name, (argv, cwd, proc_env) in specs.items():
        with open(out / f"{name}.out", "w") as o, \
                open(out / f"{name}.err", "w") as e:
            procs[name] = subprocess.Popen(
                argv, cwd=cwd, env=proc_env, stdin=subprocess.DEVNULL,
                stdout=o, stderr=e, text=True)

    def result(name, timeout):
        procs[name].wait(timeout=timeout)
        return (procs[name].returncode,
                (out / f"{name}.out").read_text(),
                (out / f"{name}.err").read_text())
    try:
        yield result
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def test_importing_the_port_loads_no_jax(children):
    rc, stdout, stderr = children("imports", timeout=60)
    assert rc == 0, stdout + stderr


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


@pytest.mark.parametrize("build", ["ResNet50", "MnistConvNet", "ViT",
                                   "entry"])
def test_vision_models_and_entry_raise_without_cuda(build):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from horovod_tpu_torch import entry, models
    make = {"ResNet50": models.ResNet50, "MnistConvNet": models.MnistConvNet,
            "ViT": lambda **kw: models.ViT(models.ViTConfig(num_layers=1),
                                           **kw),
            "entry": entry.entry}[build]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make()
    if build != "ResNet50":   # ResNet50 is built on the CPU elsewhere
        make(device="cpu")


def test_bench_refuses_to_run_without_the_card(children):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, stdout, stderr = children("bench", timeout=120)
    assert rc != 0
    assert "device='cpu'" in stderr
    assert "metric" not in stdout


def test_cuda_tests_skip_cleanly_without_a_card(children):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tests run instead")
    rc, stdout, stderr = children("cuda_tests", timeout=120)
    assert rc == 0, stdout + stderr
    assert "passed" not in stdout and "failed" not in stdout
    assert "skipped" in stdout and "needs a CUDA device" in stdout


def test_chip_smoke_fails_without_the_card_or_the_package(children):
    rc, stdout, _ = children("chip_smoke", timeout=120)
    assert rc != 0
    assert '"ok"' not in stdout
