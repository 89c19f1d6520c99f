"""The port stands alone: no module of ``odevit_tpu_torch`` and not
``chip_smoke.py`` imports JAX, flax or the JAX package; entry points
never fall back to the CPU quietly; a failed kernel build raises."""

import ast
import os
import pkgutil
import stat
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import odevit_tpu_torch
from odevit_tpu_torch import resolve_device
from odevit_tpu_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "odevit_tpu")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        odevit_tpu_torch.__path__, "odevit_tpu_torch."))


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r} and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "import chip_smoke\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_the_port_keeps_its_own_dopri5():
    """The serving slice's adaptive integrator is the port's own copy
    (checked above with every other module), not the JAX package's."""
    assert "odevit_tpu_torch.core.adaptive" in port_modules()


@pytest.mark.parametrize("path", ["chip_smoke.py", "odevit_tpu_torch"])
def test_sources_name_no_jax_import(path):
    files = [ROOT / path] if path.endswith(".py") else sorted(
        (ROOT / path).rglob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in BLOCKED, (f, name)


def test_entry_points_need_a_gpu_or_an_explicit_cpu(monkeypatch):
    from odevit_tpu_torch.models.vit_ode import ViTODE
    from odevit_tpu_torch.serve.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        ViTODE(img_size=16, patch_size=4, embed_dim=32, num_heads=2)
    m = ViTODE(img_size=16, patch_size=4, embed_dim=32, num_heads=2,
               num_classes=3, num_eval_steps=2, device="cpu")
    with pytest.raises(RuntimeError):
        ServingEngine(m, batch_buckets=(1,))
    assert resolve_device("cpu") == torch.device("cpu")
    # the distillation slice: the teacher, and the step built on a student
    # and a teacher that were asked for the CPU
    from odevit_tpu_torch.teacher.vit import ViTTeacher
    from odevit_tpu_torch.train.fast_steps import \
        make_fast_distill_train_step
    small = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=2,
                 num_heads=2, mlp_dim=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTTeacher(**small)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ViTTeacher.dino_b16()
    teacher = ViTTeacher(**small, device="cpu")
    assert next(teacher.parameters()).device == torch.device("cpu")
    assert callable(make_fast_distill_train_step(m, teacher,
                                                 lambda_param=0.5))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails makes the build raise; nothing falls back."""
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.cu").write_text("this is not C++\n")
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\necho 'error: broken.cu' >&2\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "CSRC", tmp_path / "csrc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setenv("PATH", f"{nvcc.parent}{os.pathsep}"
                       f"{os.environ['PATH']}")
    with pytest.raises(RuntimeError, match="CUDA build failed"):
        build.build(["broken"])
    assert not list((tmp_path / "out").glob("*.so"))


def test_missing_compiler_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_toolkit"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["vector_field"])


def test_editing_one_source_rebuilds_every_library(tmp_path, monkeypatch):
    """The backward includes the forward's source, so a library's name
    hashes every source: an edit of one renames both libraries."""
    (tmp_path / "a.cu").write_text("int a;\n")
    (tmp_path / "b.cu").write_text('#include "a.cu"\n')
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in ("a", "b")}
    assert before["a"] != before["b"]
    (tmp_path / "a.cu").write_text("int a = 1;\n")
    for name, path in before.items():
        assert build.library_path(name) != path


def test_editing_a_header_rebuilds_every_library(tmp_path, monkeypatch):
    """Sources include the .cuh headers of csrc (split_tf32.cuh): a
    header's edit renames every library too, and a header is no source of
    its own."""
    (tmp_path / "h.cuh").write_text("int h;\n")
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert set(build.sources()) == {"a", "b"}
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "h.cuh").write_text("int h = 1;\n")
    for name, path in before.items():
        assert build.library_path(name) != path


def test_the_only_source_is_listed():
    assert set(build.sources()) == {"vector_field", "vector_field_bwd",
                                    "vector_field_tiled", "dropout_masks",
                                    "vector_field_bwd_split", "macaron",
                                    "macaron_bwd", "macaron_tiled"}


def test_the_split_backward_is_a_port_module():
    """The split backward's wrappers and plain twins are the port's own
    module (checked above with every other module for JAX imports), built
    from its own source."""
    assert "odevit_tpu_torch.kernels.vector_field_bwd_split" in port_modules()
    assert build.sources()["vector_field_bwd_split"].parent == build.CSRC


@pytest.mark.parametrize("module", ["macaron", "macaron_bwd",
                                    "macaron_tiled"])
def test_macaron_kernels_without_a_compiler_raise(module, tmp_path,
                                                  monkeypatch):
    """The Macaron kernels' libraries are built at first use from their own
    sources; with no compiler their wrappers raise instead of running
    anything else."""
    import importlib
    mod = importlib.import_module(f"odevit_tpu_torch.kernels.{module}")
    assert f"odevit_tpu_torch.kernels.{module}" in port_modules()
    assert build.sources()[module].parent == build.CSRC
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_toolkit"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(mod, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        mod._library()


def test_split_kernels_without_a_compiler_raise(tmp_path, monkeypatch):
    """The split route's library is built at first use; with no compiler
    its wrappers raise instead of running anything else."""
    from odevit_tpu_torch.kernels import vector_field_bwd_split as split
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_toolkit"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(split, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        split._library()
