"""The port's boundary: no JAX, no ``repro``, explicit devices, no
silent fallback to the CPU, and kernels built only on demand."""
import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "export_qnet_torch.py"]


def _is_forbidden(name: str | None) -> bool:
    return bool(name) and (
        name == "jax" or name.startswith("jax.")
        or name == "repro" or name.startswith("repro.")
    )


def test_every_module_imports_without_jax_or_repro():
    """Import every repro_torch module (and chip_smoke) in a fresh process
    where ``import jax`` fails and a meta-path hook refuses ``repro``."""
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        sys.path.insert(0, {str(ROOT / "src")!r})
        sys.path.insert(0, {str(ROOT)!r})
        sys.modules["jax"] = None

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "repro" or name.startswith("repro."):
                    raise ImportError("the port must not import " + name)
                return None

        sys.meta_path.insert(0, Refuse())
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        import chip_smoke
        bad = [k for k, mod in sys.modules.items() if mod is not None
               and (k == "repro" or k.startswith(("repro.", "jax")))]
        assert not bad, bad
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_repro(path):
    """Also the lazy imports inside functions, which importing the module
    does not execute."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _is_forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_device_resolution(monkeypatch):
    from repro_torch.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve("cuda")
    with pytest.raises(RuntimeError):
        resolve()  # the default is the card
    with pytest.raises(ValueError):
        resolve("meta")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch.kernels import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not (tmp_path / "kernels").exists() or not any(
        (tmp_path / "kernels").rglob("*.so")
    )


def test_build_keys_libraries_by_source_hash():
    from repro_torch.kernels import _build

    paths = {stem: _build._lib_path(stem)
             for stem, _ in _build.ENTRIES.values()}
    assert paths["block_spmm"].parent.parent == _build.BUILD_DIR
    assert paths["block_spmm"].parent != paths["embedding_bag"].parent
    assert paths["csr_spmm"].parent.parent == _build.BUILD_DIR
    assert paths["csr_spmm"].parent not in {
        paths["block_spmm"].parent, paths["embedding_bag"].parent}
    assert all((_build.CSRC / f"{s}.cu").is_file() for s in paths)


def test_chip_smoke_refuses_without_a_card():
    """Run with no arguments on a machine with no CUDA card: it must exit
    non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py would run")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
        text=True, timeout=120, cwd=ROOT,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
