"""A job of P processes of one script on this machine, each a rank of one
``torch.distributed`` group, and what each rank wrote.

    job = spawn.Job(script, ranks, out_dir, dict(...))   # starts them
    rows = job.wait()                                    # [rank] -> dict

Rank r runs ``python SCRIPT worker r P PORT OUT_DIR ARGS_JSON``; the script
calls :func:`join` for its mesh, writes its result with :func:`write` and
leaves through :func:`finish`.  Rank 0's store listens on 127.0.0.1 at a
free port (no other host is contacted); gloo runs on the loopback
interface.  A job whose process fails or outlives ``timeout`` raises, and
no process outlives :meth:`Job.wait`.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Job:
    """``ranks`` processes of ``script``'s worker with the arguments
    ``args`` (a JSON-able dict); ``threads``: torch's threads a process."""

    def __init__(self, script, ranks: int, out_dir, args: dict,
                 threads: int = 1, timeout: float = 1800.0):
        self.out_dir, self.ranks, self.timeout = Path(out_dir), ranks, timeout
        self.out_dir.mkdir(parents=True, exist_ok=True)
        port = free_port()
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
                   OMP_NUM_THREADS=str(threads))
        self.procs = [subprocess.Popen(
            [sys.executable, str(script), "worker", str(r), str(ranks),
             str(port), str(self.out_dir), json.dumps(dict(args,
                                                          threads=threads))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(ranks)]

    def wait(self) -> list:
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=self.timeout)[0].decode())
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, o) in enumerate(zip(self.procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} of {self.ranks} exited with "
                                   f"{p.returncode}:\n{o[-3000:]}")
        return [json.loads((self.out_dir / f"{r}.json").read_text())
                for r in range(self.ranks)]


def worker_args(argv) -> tuple:
    """(rank, ranks, port, out_dir, args) from a worker's command line
    (``argv[1:]`` after the word ``worker``)."""
    rank, ranks, port, out_dir, args = argv
    args = json.loads(args)
    torch.set_num_threads(int(args["threads"]))
    return int(rank), int(ranks), int(port), Path(out_dir), args


def join(rank: int, ranks: int, port: int, device, axis: str = "batch"):
    """This process's mesh over the job's ranks: gloo on the CPU, NCCL on
    card ``rank % device_count``."""
    from . import mesh as pmesh

    pmesh.init_distributed(f"127.0.0.1:{port}", ranks, rank, device=device)
    return pmesh.make_mesh(axis=axis, device=device)


def write(out_dir, rank: int, result: dict) -> None:
    (Path(out_dir) / f"{rank}.json").write_text(json.dumps(result))


def finish() -> None:
    """Every rank past its last collective, then out without tearing the
    group down (gloo's teardown can abort a rank whose peers have gone)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
