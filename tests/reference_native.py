"""The reference's native host library for the port's parity tests, built
apart from the reference's own build directory.

dpdist_tpu/native/lib.py builds its library in place, into
dpdist_tpu/native/_build/pointcloud_native.so, whenever that file is
missing, and a process that finds the file while another process is still
writing it loads nothing and keeps None for good (its `_tried`). Under
several pytest workers on a tree with no build, the reference's tests and
these build at once, so a parity test could lose that race and compare the
port against None. The fixture here runs the reference's own `_build` (its
source, its g++ flags) into a directory of this test session, and points
the reference's module at that library while a test runs; what the
reference computes is unchanged.
"""

import pytest


@pytest.fixture(scope="session")
def _reference_native_so(tmp_path_factory):
    from dpdist_tpu.native import lib

    build_dir = tmp_path_factory.mktemp("reference_native")
    so = build_dir / "pointcloud_native.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(lib, "_BUILD_DIR", str(build_dir))
        mp.setattr(lib, "_SO", str(so))
        assert lib._build(), "g++ could not build dpdist_tpu/native/src/pointcloud_native.cpp"
    return so


@pytest.fixture
def reference_native(_reference_native_so, monkeypatch):
    """dpdist_tpu.native.lib, loading the library built for this session."""
    from dpdist_tpu.native import lib

    monkeypatch.setattr(lib, "_BUILD_DIR", str(_reference_native_so.parent))
    monkeypatch.setattr(lib, "_SO", str(_reference_native_so))
    monkeypatch.setattr(lib, "_lib", None)
    monkeypatch.setattr(lib, "_tried", False)
    assert lib.available()
    return lib
