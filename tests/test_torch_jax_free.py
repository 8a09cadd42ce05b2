"""Gate: the PyTorch port imports no jax and nothing of kube_batch_tpu.

tests/conftest.py imports jax into this process, so the check runs in a
fresh interpreter.  A ``sys.meta_path`` hook there refuses ``jax``,
``jaxlib`` and ``kube_batch_tpu`` (and their submodules, but not
``kube_batch_tpu_torch``); under it the subprocess imports every module of
the port and runs one small ship -> dispatch -> fetch on the CPU.
"""

import pkgutil
import subprocess
import sys
from pathlib import Path

import kube_batch_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, sys

BLOCKED = ("jax", "jaxlib", "kube_batch_tpu")

class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[1:]:
    importlib.import_module(name)

import torch
torch.set_num_threads(1)
from kube_batch_tpu_torch.models.shipping import resident_shipper
from kube_batch_tpu_torch.models.synthetic import make_synthetic_inputs
from kube_batch_tpu_torch.ops.solver import dispatch_solve, fetch_solve

inp, cfg = make_synthetic_inputs(120, 16, 8, 2, seed=4, dtype=torch.float32,
                                 device="cpu")
owner = type("Owner", (), {})()
shipped = resident_shipper(owner, device="cpu").ship(inp, cfg)
assignment, kind, order, ordered = fetch_solve(dispatch_solve(shipped, cfg))
assert ordered.size > 0 and (kind > 0).sum() == ordered.size
leaked = sorted(m for m in sys.modules
                if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print("placed", ordered.size)
"""


def port_modules():
    pkg = kube_batch_tpu_torch
    names = [pkg.__name__]
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        names.append(info.name)
    return names


def test_port_runs_with_jax_and_the_reference_blocked():
    modules = port_modules()
    assert {"kube_batch_tpu_torch.ops.cuda_solver",
            "kube_batch_tpu_torch.models.shipping",
            "kube_batch_tpu_torch.knobs"} <= set(modules)
    proc = subprocess.run([sys.executable, "-c", SCRIPT, *modules],
                          cwd=str(ROOT), capture_output=True, text=True,
                          timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("placed ")


def test_the_hook_does_block_the_reference():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, "kube_batch_tpu.knobs"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
        check=False)
    assert proc.returncode != 0
    assert "blocked import of kube_batch_tpu" in proc.stderr
