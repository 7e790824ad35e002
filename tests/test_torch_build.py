"""`cook_tpu_torch.build` without a CUDA toolkit: when a kernel library
counts as stale (its `.cu` or any shared `csrc/*.cuh` newer than the
`.so`), and that `load_all` starts one compiler per stale source and
raises, naming each source, when they fail."""
import os
import stat

import pytest

from cook_tpu_torch import build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "_build"
    csrc.mkdir()
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    monkeypatch.setattr(build, "_libs", {})
    return csrc, out


def _touch(path, mtime):
    path.parent.mkdir(exist_ok=True)
    path.write_text("")
    os.utime(path, (mtime, mtime))


def test_a_library_is_stale_when_its_source_or_any_header_is_newer(tree):
    csrc, out = tree
    _touch(csrc / "k.cu", 100)
    _touch(csrc / "score_tile.cuh", 100)
    assert build._stale("k")  # never built
    _touch(out / "libk.so", 200)
    assert not build._stale("k")
    _touch(csrc / "score_tile.cuh", 300)  # an edited shared header
    assert build._stale("k")
    _touch(out / "libk.so", 400)
    _touch(csrc / "k.cu", 500)
    assert build._stale("k")


def test_load_all_runs_every_stale_build_and_reports_each_failure(
        tree, monkeypatch):
    csrc, out = tree
    log = csrc.parent / "started"
    fake = csrc.parent / "nvcc"
    # a compiler that records its source and fails
    fake.write_text(f"#!/bin/sh\necho \"$@\" >> {log}\necho broken >&2\n"
                    "exit 3\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    for name in ("a", "b"):
        _touch(csrc / f"{name}.cu", 100)
    with pytest.raises(RuntimeError) as err:
        build.load_all(["a", "b", "a"])
    message = str(err.value)
    assert "csrc/a.cu (exit 3)" in message and "csrc/b.cu" in message
    assert "broken" in message
    started = log.read_text().splitlines()
    assert len(started) == 2  # one compiler per distinct source
    assert all("--fmad=false" in line for line in started)
    assert not build._libs


def test_nvcc_is_required_to_build(tree, monkeypatch):
    csrc, _ = tree
    _touch(csrc / "k.cu", 100)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(csrc))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("k")


@pytest.mark.parametrize("header", ["score_tile.cuh", "node_tile.cuh",
                                    "block_score.cuh"])
def test_an_edited_shared_header_rebuilds_every_kernel(tree, header):
    csrc, out = tree
    names = ("best_node", "best_block", "best_node_batched", "coarse_pass")
    for name in names:
        _touch(csrc / f"{name}.cu", 100)
        _touch(out / f"lib{name}.so", 200)
    _touch(csrc / header, 100)
    assert not any(build._stale(name) for name in names)
    _touch(csrc / header, 300)
    assert all(build._stale(name) for name in names)


def test_every_kernel_source_is_registered():
    """Each `csrc/*.cu` is one kernel: chip_smoke.py builds, checks and
    reports it, and its wrapper module counts launches and has a plain
    version."""
    import glob
    import importlib

    import chip_smoke

    sources = sorted(os.path.basename(p)[:-len(".cu")] for p in
                     glob.glob(os.path.join(build.CSRC_DIR, "*.cu")))
    assert sources == sorted(chip_smoke.KERNELS)
    assert {"best_node", "best_block", "best_node_batched",
            "coarse_pass"} <= set(sources)
    for name, (module, source, replaces) in chip_smoke.KERNELS.items():
        assert source == f"cook_tpu_torch/csrc/{name}.cu"
        assert replaces.startswith("cook_tpu/ops/pallas_match.py:")
        mod = importlib.import_module(module)
        assert isinstance(mod.launches, int)
        assert callable(getattr(mod, name))
        assert callable(getattr(mod, f"{name}_reference"))
