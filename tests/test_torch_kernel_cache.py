"""K1's build directory as the port's persistent compile cache, on the
CPU (kube_batch_tpu_torch/ops/cuda_solver.build_kernel and
ops/compile_cache.enable_persistent_cache).

The reference's ``TestPersistentCache`` (tests/test_compile_cache.py)
asserts JAX's own persistent-cache hit event; here the cache hit is a
library load with no ``nvcc`` run, with ``subprocess.run`` and
``ctypes.CDLL`` stubbed (there is no CUDA toolkit on the CPU).  Also:
two threads that build the kernel for the first time share one build
and one handle; a library loaded before the directory was set is copied
there; the manifest's version key holds the fields the port keys on.
"""

import ctypes
import json
import os
import subprocess
import sys
import threading
import time
import types

import pytest

import kube_batch_tpu_torch.ops.compile_cache as cc
import kube_batch_tpu_torch.ops.cuda_solver as cuda_solver
from kube_batch_tpu_torch.ops.compile_cache import (BucketSpec, SolverWarmup,
                                                    enable_persistent_cache,
                                                    read_manifest)


class FakeToolchain:
    """``nvcc`` as a stub that writes its ``-o`` file (after ``delay``
    seconds) and records its runs (``builds`` counts the links, one per
    build: cuda_solver.UNITS plus the entry unit compile before each);
    ``ctypes.CDLL`` as a stub that returns one handle per path."""

    def __init__(self, delay=0.0):
        self.delay = delay
        self.runs = []
        self.loads = []
        self.handles = {}
        self.lock = threading.Lock()

    @property
    def builds(self):
        return sum("-shared" in argv for argv in self.runs)

    def run(self, argv, **_kw):
        out = argv[argv.index("-o") + 1]
        with self.lock:
            self.runs.append(list(argv))
        time.sleep(self.delay)
        with open(out, "wb") as f:
            f.write(b"\x7fELF fake kernel library")
        report = "" if "-shared" in argv else "ptxas info: fake\n"
        return subprocess.CompletedProcess(argv, 0, "", report)

    def cdll(self, path):
        with self.lock:
            self.loads.append(path)
            return self.handles.setdefault(path, types.SimpleNamespace(
                kbt_solve_session=types.SimpleNamespace(),
                kbt_cluster_capacity=types.SimpleNamespace(),
                kbt_error_string=types.SimpleNamespace(),
                kbt_xchg_alloc=types.SimpleNamespace(),
                kbt_stream_create=types.SimpleNamespace()))


@pytest.fixture
def toolchain(monkeypatch, tmp_path):
    """The stubbed toolchain, K1 not loaded, and the default build
    directory under ``tmp_path``; everything restored afterwards."""
    fake = FakeToolchain()
    monkeypatch.setattr(subprocess, "run", fake.run)
    monkeypatch.setattr(ctypes, "CDLL", fake.cdll)
    monkeypatch.setattr(cuda_solver.shutil, "which",
                        lambda _name: sys.executable)
    monkeypatch.setattr(cuda_solver, "BUILD_DIR", tmp_path / "default")
    monkeypatch.setattr(cuda_solver._Kernel, "lib", None)
    monkeypatch.setattr(cuda_solver._Kernel, "build_log", "")
    monkeypatch.setattr(cuda_solver._Kernel, "build_dir", None,
                        raising=False)
    monkeypatch.setattr(cuda_solver._Kernel, "path", None, raising=False)
    monkeypatch.setattr(cuda_solver._Kernel, "built", None, raising=False)
    for attr, value in (("lib", None), ("build_log", ""), ("path", None),
                        ("built", None)):
        monkeypatch.setattr(cuda_solver._ShardKernel, attr, value)
    monkeypatch.setattr(cc, "_cache_dir", None)
    return fake


class TestPersistentCache:
    def test_cache_dir_reuse_across_two_instantiations(self, toolchain,
                                                       tmp_path):
        """The first boot builds K1 into the cache dir and its warmup
        writes the manifest; a second instantiation (the in-process
        library dropped) loads the library from the dir without nvcc."""
        spec = BucketSpec(60, 24, 8, 4)
        cache_dir = str(tmp_path / "cc")
        assert enable_persistent_cache(cache_dir) == os.path.abspath(
            cache_dir)
        first = SolverWarmup([spec], cache_dir=cache_dir, device="cpu")
        first.start().join(300)
        assert first.done and not first.errors
        manifest = read_manifest(cache_dir)
        assert manifest["warmed"], "warmup recorded nothing"
        entry = next(iter(manifest["warmed"].values()))
        assert entry["spec"] == list(spec)

        lib = cuda_solver.build_kernel()
        assert toolchain.builds == 1
        assert cuda_solver._Kernel.built is True
        so = cuda_solver.library_path()
        assert so.parent == cuda_solver.Path(cache_dir)
        assert so.exists() and not list(so.parent.glob("*.tmp"))

        cuda_solver._Kernel.lib = None  # second instantiation
        cuda_solver._Kernel.build_log = ""
        again = cuda_solver.build_kernel()
        assert toolchain.builds == 1, "the second load ran nvcc"
        assert len(toolchain.runs) == len(cuda_solver.UNITS) + 2
        assert cuda_solver._Kernel.built is False
        assert cuda_solver._Kernel.build_log == "ptxas info: fake\n" * (
            len(cuda_solver.UNITS) + 1)
        assert toolchain.loads == [str(so), str(so)]
        assert again is lib

    def test_manifest_version_mismatch_resets(self, tmp_path):
        cache_dir = str(tmp_path)
        with open(os.path.join(cache_dir, cc._MANIFEST_NAME), "w") as f:
            json.dump({"version": {"torch": "0.0.0"},
                       "warmed": {"stale": {}}}, f)
        assert read_manifest(cache_dir)["warmed"] == {}

    def test_manifest_survives_garbage_file(self, tmp_path):
        cache_dir = str(tmp_path)
        with open(os.path.join(cache_dir, cc._MANIFEST_NAME), "w") as f:
            f.write("{not json")
        assert read_manifest(cache_dir)["warmed"] == {}


class TestBuildKernel:
    def test_two_threads_share_one_build(self, toolchain):
        """Two threads that reach the first build together (the boot
        warmup and the scheduler's first session) run nvcc once and get
        the same handle; no temporary file is left."""
        toolchain.delay = 0.2
        start = threading.Barrier(2)
        got = []

        def build():
            start.wait()
            got.append(cuda_solver.build_kernel())

        threads = [threading.Thread(target=build) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert toolchain.builds == 1
        assert len(toolchain.runs) == len(cuda_solver.UNITS) + 2
        assert len(got) == 2 and got[0] is got[1]
        so = f"libsolve_session_{cuda_solver.kernel_tag()}.so"
        assert sorted(p.name for p in cuda_solver.BUILD_DIR.iterdir()) == [
            so, f"{so}.ptxas.txt"]
        assert cuda_solver._Kernel.build_log == "ptxas info: fake\n" * (
            len(cuda_solver.UNITS) + 1)

    def test_set_build_dir_copies_a_loaded_library(self, toolchain,
                                                   tmp_path):
        """A library loaded before the cache dir is set stays loaded and
        is copied into the dir, so the next boot loads it there."""
        lib = cuda_solver.build_kernel()
        first = cuda_solver._Kernel.path
        assert first.parent == cuda_solver.BUILD_DIR
        enable_persistent_cache(str(tmp_path / "cc"))
        assert cuda_solver.build_kernel() is lib
        copied = cuda_solver.library_path()
        assert copied.parent == (tmp_path / "cc").resolve()
        assert copied.read_bytes() == first.read_bytes()
        cuda_solver._Kernel.lib = None  # the next boot
        cuda_solver.build_kernel()
        assert toolchain.builds == 1
        assert toolchain.loads[-1] == str(copied)

    def test_units_compile_apart_and_link_once(self, toolchain):
        """One nvcc per unit, each with its own (float type, stamps,
        on-chip) defines, plus the entry unit without them, then one link
        of every object; no object file is left."""
        cuda_solver.build_kernel()
        *compiles, link = toolchain.runs
        units = {tuple(a for a in argv if a.startswith("-DKBT"))
                 for argv in compiles}
        assert len(compiles) == len(units) == len(cuda_solver.UNITS) + 1
        assert () in units
        assert {u for u in units if u} == {
            tuple(cuda_solver._unit_flags(u)) for u in cuda_solver.UNITS}
        objs = [argv[argv.index("-o") + 1] for argv in compiles]
        assert "-shared" in link and set(objs) <= set(link)
        assert not list(cuda_solver.BUILD_DIR.glob("*.o"))

    def test_shard_mode_builds_apart_at_first_use(self, toolchain,
                                                  tmp_path):
        """K1's build compiles no shard-mode unit, so a host that never
        shards never pays for it; the first sharded solve's build
        compiles SHARD_UNITS and an entry unit with -DKBT_ENTRY_SHARD
        into a library of its own, once, and a cache dir set afterwards
        gets both libraries."""
        lib = cuda_solver.build_kernel()
        flags = {a for argv in toolchain.runs for a in argv}
        assert "-DKBT_UNIT_SHARD=true" not in flags
        assert "-DKBT_ENTRY_SHARD" not in flags
        assert cuda_solver._ShardKernel.lib is None
        runs = len(toolchain.runs)
        shard = cuda_solver.build_shard_kernel()
        assert shard is not lib and cuda_solver.build_shard_kernel() is shard
        *compiles, link = toolchain.runs[runs:]
        assert toolchain.builds == 2 and "-shared" in link
        units = {tuple(a for a in argv if a.startswith("-DKBT"))
                 for argv in compiles}
        assert units == {tuple(cuda_solver._unit_flags(u))
                         for u in cuda_solver.SHARD_UNITS} | {
                             ("-DKBT_ENTRY_SHARD",)}
        so = cuda_solver.library_path(which=cuda_solver._ShardKernel)
        assert so.name.startswith("libsolve_session_shard_")
        assert so != cuda_solver.library_path() and so.exists()
        assert cuda_solver.kernel_tag(cuda_solver._ShardKernel) \
            != cuda_solver.kernel_tag()
        enable_persistent_cache(str(tmp_path / "cc"))
        assert sorted(p.name for p in (tmp_path / "cc").glob("*.so")) == \
            sorted([cuda_solver.library_path().name, so.name])

    def test_version_key_holds_the_build_identity(self, tmp_path):
        """A manifest entry is kept only under the same torch, CUDA,
        device, kernel source and flags, and port version."""
        import torch

        from kube_batch_tpu_torch.version import __version__
        key = cc._version_key()
        assert key == {"torch": torch.__version__, "cuda": torch.version.cuda,
                       "device": "cpu", "kernel": cuda_solver.kernel_tag(),
                       "kube_batch_tpu_torch": __version__}
        cc.record_warmed(str(tmp_path), {"k": {"spec": [1, 1, 1, 1]}})
        assert read_manifest(str(tmp_path))["warmed"] == {
            "k": {"spec": [1, 1, 1, 1]}}
        with open(os.path.join(str(tmp_path), cc._MANIFEST_NAME)) as f:
            doc = json.load(f)
        doc["version"]["kernel"] = "0" * 16
        with open(os.path.join(str(tmp_path), cc._MANIFEST_NAME), "w") as f:
            json.dump(doc, f)
        assert read_manifest(str(tmp_path))["warmed"] == {}
