"""Process entry point (kube_batch_tpu/cli/main.py).

    python -m kube_batch_tpu_torch.cli.main [flags]
    kube-batch-tpu-torch [flags]          (the console script)

The daemon has no device flag: it runs on the card.  Without one it
exits non-zero with ``device.resolve_device``'s message; it never
carries on on the CPU.  SIGINT and SIGTERM stop it in the runtime's
order (warmup, elector, scheduler loop, leases, metrics endpoint).
"""

from __future__ import annotations

import signal
import sys
import threading


def main(argv=None) -> int:
    from ..version import version_string
    from .options import parse_options

    opt = parse_options(argv)
    if opt.print_version:
        print(version_string())
        return 0

    from ..device import resolve_device
    try:
        device = resolve_device(None)
    except RuntimeError as exc:
        print(f"kube-batch-tpu-torch: {exc}", file=sys.stderr)
        return 1

    # The Scheduler registers the default actions (on the card) and
    # plugins, as the reference's main does by blank import.
    from .server import ServerRuntime
    runtime = ServerRuntime(opt, device=device)
    runtime.run()

    stop = threading.Event()

    def handle(sig, frame):
        stop.set()

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    stop.wait()
    runtime.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
