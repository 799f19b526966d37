"""Serving entrypoint: ``python -m mmlspark_tpu_torch.serving``.

Deployment surface for the docker/helm tooling (parity role: the reference's
serving containers under ``tools/helm``). Modes:

* ``--driver``: run the driver registry (one per cluster).
* default: run a worker. With ``--driver-url`` (or env
  ``MMLSPARK_TPU_DRIVER_URL``) the worker joins the distributed cluster
  (registration + heartbeat + cross-worker routing); without it, a
  standalone single-host WorkerServer.

The port's copy of ``mmlspark_tpu/serving/__main__.py``.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import threading


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m mmlspark_tpu_torch.serving")
    p.add_argument("--driver", action="store_true",
                   help="run the driver registry instead of a worker")
    p.add_argument("--host", default=os.environ.get(
        "MMLSPARK_TPU_SERVING_HOST", "0.0.0.0"))
    p.add_argument("--port", type=int, default=int(os.environ.get(
        "MMLSPARK_TPU_SERVING_PORT", "8898")))
    p.add_argument("--driver-url", default=os.environ.get(
        "MMLSPARK_TPU_DRIVER_URL", ""))
    p.add_argument("--advertise-host", default=os.environ.get(
        "MMLSPARK_TPU_ADVERTISE_HOST", ""),
        help="peer-routable host registered with the driver (e.g. pod IP); "
             "required whenever binding 0.0.0.0 behind NAT")
    p.add_argument("--worker-id", default=os.environ.get(
        "MMLSPARK_TPU_WORKER_ID", "") or socket.gethostname())
    p.add_argument("--liveness-timeout", type=float, default=30.0)
    args = p.parse_args(argv)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, lambda *_: stop.set())
        except ValueError:
            pass  # non-main thread (tests)

    if args.driver:
        from .distributed import DriverRegistry
        reg = DriverRegistry(host=args.host, port=args.port,
                             liveness_timeout=args.liveness_timeout)
        print(f"driver registry on {reg.url}", flush=True)
        stop.wait()
        reg.close()
        return 0

    if args.driver_url:
        from .distributed import DistributedWorker
        worker = DistributedWorker(args.driver_url, args.worker_id,
                                   host=args.host, port=args.port,
                                   advertise_host=args.advertise_host)
        print(f"worker {args.worker_id} on {worker.advertised_address} "
              f"(driver {args.driver_url})", flush=True)
        stop.wait()
        worker.close()
    else:
        from .server import WorkerServer
        server = WorkerServer(host=args.host, port=args.port)
        print(f"standalone worker on {server.address}", flush=True)
        stop.wait()
        server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
