"""Version info (the port's own copy of kube_batch_tpu/version.py: a plain
module constant, reported by ``--version`` and keyed into the compile
cache's manifest)."""

__version__ = "0.1.0"

API_VERSION = "v1alpha1"


def version_string() -> str:
    return f"kube-batch-tpu-torch {__version__} (api {API_VERSION})"
