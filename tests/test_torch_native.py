"""The port's native host library (``video_stab_tpu_torch/native``)
against the JAX package's: the ``TestNative`` cases of ``tests/test_io.py``
(the frame ring, the pacing clock, the C++ TCP receiver, a failed build
remembered) run once per package. Then the port's own build: its C++
sources are byte-identical copies of the JAX package's, eight processes
that call ``available()`` at once on a fresh checkout build each library
once (an ``flock`` and a rename, where the JAX package runs ``make`` from
every worker), and where the libavcodec headers exist the codec layer
builds, so that a broken build cannot hide as skipped codec tests.
"""

import os
import shutil
import socket
import subprocess
import sys
import textwrap
import time
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from video_stab_tpu import native as jnative  # noqa: E402
from video_stab_tpu_torch import native as tnative  # noqa: E402
from video_stab_tpu_torch.io import codec as tcodec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _fail_jax_build(monkeypatch, calls):
    def failing_build():
        calls["n"] += 1
        return False

    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    monkeypatch.setattr(jnative, "_LIB_PATH", "/nonexistent/lib.so")
    monkeypatch.setattr(jnative, "_build", failing_build)


def _fail_torch_build(monkeypatch, calls):
    def failing_build(name):
        calls["n"] += 1
        raise RuntimeError("g++: error: no toolchain")

    monkeypatch.setattr(tnative, "_loaded", {})
    monkeypatch.setattr(tnative, "_errors", {})
    monkeypatch.setattr(tnative, "build", failing_build)


PACKAGES = {
    "jax": types.SimpleNamespace(native=jnative, fail_build=_fail_jax_build),
    "torch": types.SimpleNamespace(native=tnative,
                                   fail_build=_fail_torch_build),
}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    return PACKAGES[request.param]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _have_libav_headers() -> bool:
    return any(os.path.exists(os.path.join(d, "libavcodec", "avcodec.h"))
               for d in ("/usr/include", "/usr/local/include",
                         "/usr/include/x86_64-linux-gnu",
                         "/usr/include/aarch64-linux-gnu"))


class TestNative:
    @pytest.fixture(autouse=True)
    def _skip_without_lib(self, pkg):
        if not pkg.native.available():
            pytest.skip("native toolchain unavailable")

    def test_frame_ring_drop_oldest(self, pkg):
        ring = pkg.native.FrameRing((8, 8, 3), capacity=3)
        for i in range(5):
            ring.push(np.full((8, 8, 3), i, np.uint8), stamp=i)
        assert len(ring) == 3
        frame, stamp = ring.pop()
        assert stamp == 2 and frame[0, 0, 0] == 2   # oldest two dropped
        assert ring.stats["dropped"] == 2
        ring.close()

    def test_pacing_clock(self, pkg):
        pc = pkg.native.PacingClock(200.0)
        t0 = time.perf_counter()
        for _ in range(10):
            pc.wait()
        dt = time.perf_counter() - t0
        assert 0.03 < dt < 0.3
        pc.close()

    def test_native_tcp(self, pkg):
        port = _free_port()
        tcp = pkg.native.NativeTcpReceiver(port)
        s = socket.create_connection(("127.0.0.1", port))
        s.sendall(b"5 6\n")
        time.sleep(0.3)
        assert tcp.try_get_latest() == (5, 6)
        assert tcp.try_get_latest() is None
        s.close()
        tcp.stop()

    def test_load_failure_is_cached(self, pkg, monkeypatch):
        """On a toolchain-less host a failed build must be remembered —
        otherwise every available() probe re-runs the compiler."""
        calls = {"n": 0}
        pkg.fail_build(monkeypatch, calls)
        assert pkg.native.available() is False
        assert pkg.native.available() is False
        assert calls["n"] == 1          # second probe hits the cache
        # monkeypatch restores the loader's state for later tests


@pytest.mark.parametrize("source", ["codec.cpp", "frame_ring.cpp"])
def test_cpp_sources_are_copies_of_the_jax_packages(source):
    ours = (REPO / "video_stab_tpu_torch" / "native" / source).read_bytes()
    theirs = (REPO / "video_stab_tpu" / "native" / source).read_bytes()
    assert ours == theirs


def test_failed_build_reports_the_compilers_message(monkeypatch):
    monkeypatch.setattr(tnative, "_loaded", {})
    monkeypatch.setattr(tnative, "_errors", {})
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    assert tnative.available() is False
    assert "/nonexistent/g++" in tnative.build_error("vstab_host")


_CHILD = textwrap.dedent("""
    import importlib.util, sys
    spec = importlib.util.spec_from_file_location("native_copy", sys.argv[1])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    host = mod.available()
    codec = mod.load("vstab_codec", lambda lib: None) is not None
    print(host, codec, mod.build_error("vstab_codec"), flush=True)
""")


def test_concurrent_first_builds_compile_each_library_once(tmp_path):
    """Eight processes call available() on a checkout with nothing built:
    every one loads a library, and each library is compiled once (one
    line per compile in builds.log), never raced into a torn file."""
    if shutil.which(os.environ.get("CXX") or "g++") is None:
        pytest.skip("no C++ compiler")
    native_dir = tmp_path / "checkout" / "pkg" / "native"
    native_dir.mkdir(parents=True)
    for name in ("__init__.py", "codec.cpp", "frame_ring.cpp"):
        shutil.copy(REPO / "video_stab_tpu_torch" / "native" / name,
                    native_dir / name)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(native_dir / "__init__.py")],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        for _ in range(8)]
    outs = [p.communicate(timeout=600)[0].split(maxsplit=2) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    want_codec = _have_libav_headers()
    assert all(o[0] == "True" for o in outs), outs
    if want_codec:
        assert all(o[1] == "True" for o in outs), outs
    build = tmp_path / "checkout" / "build" / "torch_native"
    log = (build / "builds.log").read_text().splitlines()
    assert len(log) == 1 + int(want_codec), log
    assert sum("vstab_host" in line for line in log) == 1, log
    assert sum("vstab_codec" in line for line in log) == int(want_codec)
    assert not list(build.glob("*.tmp"))


def test_codec_builds_where_the_libavcodec_headers_exist():
    if not _have_libav_headers():
        pytest.skip("no libavcodec headers on this host")
    assert tcodec.available("libx264"), \
        tnative.build_error("vstab_codec")
    assert tnative.library_path("vstab_codec").exists()


_FAKE_NVCC = """#!/bin/sh
# Writes the file after -o, as nvcc would, after a pause that lets
# concurrent builds overlap.
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
sleep 0.2
echo "ptxas info: stand-in compiler"
echo built > "$out"
"""


def test_concurrent_kernel_builds_compile_once(tmp_path):
    """The CUDA kernels' build goes through the same lock as the host
    library's: four processes that call ``kernels._lib.build()`` at once
    on a fresh copy of the package (with a stand-in ``nvcc`` that writes
    its outputs) get one library, compiled once, and leave no temporary
    file or object behind."""
    checkout = tmp_path / "checkout"
    shutil.copytree(REPO / "video_stab_tpu_torch",
                    checkout / "video_stab_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=str(checkout))
    code = ("from video_stab_tpu_torch.kernels import _lib; "
            "print(_lib.build())")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=checkout,
                              env=env, stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = {p.communicate(timeout=300)[0].strip() for p in procs}
    assert all(p.returncode == 0 for p in procs)
    build = checkout / "build" / "torch_kernels"
    assert len(outs) == 1, outs
    lib = Path(outs.pop())
    assert lib.parent == build and lib.read_text() == "built\n"
    assert len((build / "builds.log").read_text().splitlines()) == 1
    assert "stand-in compiler" in lib.with_suffix(".log").read_text()
    assert not list(build.glob("*.tmp")) and not list(build.glob("*.o"))
