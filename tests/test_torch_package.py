"""Packaging rules of the port: it imports neither jax, click nor the JAX
package, and its kernel library builds once per process, under a lock, named
by its sources and headers."""

import ast
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from epik_tpu_torch.kernels import _build

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_neither_jax_nor_click():
    """In a fresh interpreter (this one has jax loaded by conftest.py): every
    module of the port, and ``chip_smoke`` imported as a module (its
    ``main`` not run), leave jax, click and the JAX package ``epik_tpu``
    out of ``sys.modules``: the port keeps its own copies of the host
    modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import epik_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(epik_tpu_torch.__path__, "
        "'epik_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m in ('jax', 'click', 'epik_tpu') "
        "or m.startswith('epik_tpu.')]\n"
        "print(*mods)\n"
        "print(*bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods, loaded = out.stdout.split("\n")[:2]
    mods = set(mods.split())
    assert len(mods) >= 40
    # the commands, tools and multi-process modules walked too
    assert {f"epik_tpu_torch.{m}" for m in (
        "cli.main", "parallel.mesh", "parallel.sharding", "tools.ppdiff", "tools.probe_ipk",
        "tools.verify_cuda", "tools.multihost_worker")} <= mods
    assert loaded.split() == []


def test_no_import_names_the_jax_package():
    """Imports inside functions as well: no import statement of the port, of
    ``chip_smoke.py``, ``step_times.py`` or ``kernel_sweep.py`` names
    ``jax``, ``click`` or ``epik_tpu``."""
    files = sorted((REPO / "epik_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "step_times.py", REPO / "kernel_sweep.py"]
    found = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] in ("jax", "click", "epik_tpu")]
    assert len(files) >= 40 and found == []


class _FakeLib:
    """Stands in for the CDLL: each entry point takes argtypes/restype."""

    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def test_kernel_build_runs_once_across_threads(tmp_path, monkeypatch):
    lib = _build.KernelLibrary(build_dir=tmp_path)
    calls = []

    def fake_compile(out):
        calls.append(out)
        time.sleep(0.05)
        out.write_bytes(b"")

    monkeypatch.setattr(lib, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _FakeLib())
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: got.append(lib.load()))
                   for _ in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(got) == 24
    assert all(g is got[0] for g in got)
    assert got[0].epik_rowgather_sum.argtypes == _build._PROTOTYPES["epik_rowgather_sum"]


def test_library_name_follows_sources(tmp_path):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    lib = _build.KernelLibrary(csrc=src, build_dir=tmp_path / "build")
    first = lib.path()
    assert first == lib.path() and first.parent == tmp_path / "build"
    (src / "a.cu").write_text("// two\n")
    second = lib.path()
    assert second != first
    (src / "a.cuh").write_text("// a header the sources include\n")
    assert lib.path() != second and [p.name for p in lib.sources()] == ["a.cu"]
    assert [p.name for p in _build.KernelLibrary().sources()] == [
        "accumulate_packed_topk.cu", "accumulate_sums.cu", "finish_cols.cu",
        "finish_topk.cu", "rowgather_sum.cu", "tokenize.cu"]


def test_compile_runs_one_nvcc_per_source_then_links(tmp_path, monkeypatch):
    """A stand-in nvcc records its calls: every source is compiled with -c
    into its own object before the one link, the objects are removed, and a
    source that fails to compile raises naming it."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (src / name).write_text("// kernel\n")
    log = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'case "$*" in *bad.cu*) echo "bad.cu: error" >&2; exit 2;; esac\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'touch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    lib = _build.KernelLibrary(csrc=src, build_dir=tmp_path / "build")
    out = lib.path()
    lib._compile(out)
    calls = log.read_text().splitlines()
    assert len(calls) == 4 and all(" -c " in c for c in calls[:3])
    assert "-shared" in calls[3] and " -c " not in calls[3]
    assert out.exists() and list(out.parent.glob("*.o")) == []
    (src / "bad.cu").write_text("// does not compile\n")
    with pytest.raises(RuntimeError, match="bad.cu"):
        lib._compile(lib.path())
