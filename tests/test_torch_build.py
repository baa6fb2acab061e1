"""The port's kernel build bookkeeping (``repro_torch.kernels._build``), on
the CPU: where a library lands and where its ptxas report is kept. No
``nvcc`` is needed: nothing here compiles."""
import pytest

from repro_torch.kernels import _build


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "build_logs", {})
    return tmp_path


@pytest.mark.parametrize("stem", sorted({s for s, _ in
                                         _build.ENTRIES.values()}))
def test_lib_path_follows_the_source_and_the_flags(stem, build_dir,
                                                   monkeypatch):
    """An edited source or a changed flag gets a library of its own, so a
    stale one is never reused."""
    path = _build._lib_path(stem)
    assert path.parent.parent == build_dir / "kernels"
    assert path.name == f"lib{stem}.so"
    assert _build._lib_path(stem) == path
    monkeypatch.setattr(_build, "NVCC_FLAGS",
                        _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._lib_path(stem) != path
    monkeypatch.undo()
    csrc = build_dir / "csrc"
    csrc.mkdir()
    # the headers the source includes come along unedited
    for header in _build.sources(stem)[1:]:
        (csrc / header.name).write_text(header.read_text())
    src = (_build.CSRC / f"{stem}.cu").read_text()
    (csrc / f"{stem}.cu").write_text(src + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir / "kernels")
    assert _build._lib_path(stem) != path


def test_build_log_is_kept_beside_the_library(build_dir):
    """The ptxas report outlives the process that built the library, so a
    run that reuses it can still read registers and spills."""
    assert _build.build_log("flash_attention") is None
    lib = _build._lib_path("flash_attention")
    lib.parent.mkdir(parents=True)
    lib.with_suffix(".log").write_text("ptxas info    : Used 117 registers")
    assert _build.build_log("flash_attention") == (
        "ptxas info    : Used 117 registers")
    _build.build_logs["flash_attention"] = "from this process"
    assert _build.build_log("flash_attention") == "from this process"
