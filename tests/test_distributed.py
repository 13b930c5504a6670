"""Real multi-process `jax.distributed` run over localhost DCN.

The reference's distributed story is two cooperating processes joined
by UDP (Transceiver52M/Transceiver.cpp:42-44); BASELINE asks for ≥80%
scaling efficiency at ≥2 hosts. Real multi-host accelerators are not
available in CI, so this test stands up the real thing at CPU scale:
two OS processes, a `jax.distributed` coordinator on localhost, one
virtual CPU device each, and the full `sharded_uplink_pipeline`
(ppermute halos + psum clock + state-carry collectives) spanning both
processes. Each process checks its addressable result shards against a
serial single-device reference (tools/distributed_worker.py).
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tools", "distributed_worker.py")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("devices_per_proc", [1, 2])
def test_two_process_pipeline(devices_per_proc):
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                            f"{devices_per_proc}")
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "3"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert {r["process"] for r in results} == {0, 1}
    for r in results:
        assert r["n_processes"] == 2
        assert r["n_devices"] == 2 * devices_per_proc
        assert r["ok"], r
        assert r["mismatches"] == 0
    # both processes saw detections in their own shards
    assert all(r["local_hits"] > 0 for r in results)


def test_two_process_duplex_pipeline():
    """The full-duplex sharded step across two OS processes: the tx
    symbol-halo ring and the rx halos both ride the cross-process
    transport; every process verifies its addressable TX shards against
    the serial modulator and its RX shards against the serial engine."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
        env["JAX_COORDINATOR_ADDRESS"] = f"127.0.0.1:{port}"
        env["JAX_NUM_PROCESSES"] = "2"
        env["JAX_PROCESS_ID"] = str(pid)
        env["WORKER_DUPLEX"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, "3"], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    results = []
    for p in procs:
        out, err = p.communicate(timeout=420)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"
        results.append(json.loads(out.strip().splitlines()[-1]))
    for r in results:
        assert r["duplex"] and r["ok"], r
        assert r["mismatches"] == 0
        assert r["local_hits"] > 0
