"""Multi-host startup and cross-host conventions.

The reference is strictly single-process (SURVEY §2c). On a multi-host
cluster the same SPMD program runs on every host: `initialize()` wires up
the JAX distributed runtime (explicit args, or launcher variables it
detects), after which `jax.devices()` spans every host's GPUs and the 1-D
batch mesh from `parallel.mesh` covers them all — gradient psum and the
ELBO mean become cross-host collectives with no further code changes.

Reproducibility contract: per-shard PRNG streams are derived by
`fold_in(key, global_shard_index)` (`parallel/sharded.py`), so an N-host run
is statistically equivalent to a 1-host run with N× the Monte-Carlo batch —
not bitwise, since sample partitioning differs (SURVEY §7 hard-part #5).
"""

from __future__ import annotations

import os

import jax

__all__ = [
    "initialize",
    "is_multi_host",
    "host_count",
    "host_index",
    "detect_cluster_env",
    "barrier",
]

_DEFAULT_PORT = 8476


def detect_cluster_env(
    environ=None,
) -> tuple[str | None, int | None, int | None]:
    """Detect (coordinator_address, num_processes, process_id) from launcher
    environment variables, for clusters JAX does not auto-detect.

    Recognized, in priority order:

      * explicit `NF_COORDINATOR` / `NF_NUM_PROCESSES` / `NF_PROCESS_ID`
        (this framework's own launcher contract);
      * SLURM: `SLURM_STEP_NODELIST` (first host) + `SLURM_NTASKS` +
        `SLURM_PROCID`;
      * OpenMPI (mpirun): `OMPI_MCA_orte_hnp_uri` (host extracted) +
        `OMPI_COMM_WORLD_SIZE` + `OMPI_COMM_WORLD_RANK`.

    Returns (None, None, None) when nothing is recognized; then
    `jax.distributed.initialize()` is left to its own cluster detection.
    """
    env = os.environ if environ is None else environ

    if "NF_COORDINATOR" in env:
        return (
            env["NF_COORDINATOR"],
            int(env["NF_NUM_PROCESSES"]),
            int(env["NF_PROCESS_ID"]),
        )

    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        nodelist = env.get("SLURM_STEP_NODELIST", env.get("SLURM_NODELIST"))
        if nodelist:
            return (
                f"{_slurm_first_host(nodelist)}:{_DEFAULT_PORT}",
                int(env["SLURM_NTASKS"]),
                int(env["SLURM_PROCID"]),
            )

    if "OMPI_COMM_WORLD_RANK" in env and "OMPI_COMM_WORLD_SIZE" in env:
        coord = env.get("NF_COORDINATOR_HOST", "127.0.0.1")
        return (
            f"{coord}:{_DEFAULT_PORT}",
            int(env["OMPI_COMM_WORLD_SIZE"]),
            int(env["OMPI_COMM_WORLD_RANK"]),
        )

    return None, None, None


def _slurm_first_host(nodelist: str) -> str:
    """First hostname of a SLURM compressed nodelist.

    Handles every `scontrol show hostnames`-style shape:
    ``host[001-004,007]`` → host001; ``host[005,009-012]`` → host005;
    ``hosta,hostb`` → hosta; ``gpu-[3-4]srv,x`` (suffix after brackets) →
    gpu-3srv. Only the FIRST host is needed (it runs the coordinator).
    """
    # split on commas OUTSIDE brackets to isolate the first element
    depth, first = 0, []
    for ch in nodelist:
        if ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            break
        first.append(ch)
    s = "".join(first)
    # expand EVERY bracket group ("rack[1-2]node[01-08]" is a valid
    # scontrol shape): loop until no '[' remains
    while "[" in s:
        prefix, rest = s.split("[", 1)
        body, _, suffix = rest.partition("]")
        # first element of the range list: "001-004,007" → "001"
        first_item = body.split(",")[0].split("-")[0]
        s = prefix + first_item + suffix
    return s


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    detect_env: bool = True,
) -> None:
    """Initialize the JAX distributed runtime (idempotent, safe on 1 host).

    Explicit args override everything; otherwise ``detect_env=True`` fills them from
    SLURM / OpenMPI / NF_* launcher variables (`detect_cluster_env`)."""
    if coordinator_address is None and detect_env:
        coordinator_address, det_n, det_i = detect_cluster_env()
        if num_processes is None:
            num_processes = det_n
        if process_id is None:
            process_id = det_i
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:  # already initialized
        if "already" not in str(e).lower():
            raise


def is_multi_host() -> bool:
    return jax.process_count() > 1


def host_count() -> int:
    return jax.process_count()


def host_index() -> int:
    return jax.process_index()


def barrier(name: str = "nf_barrier") -> None:
    """Block until every host reaches this point (no-op on one host).

    A tiny all-reduce over one scalar per process — the portable way to
    fence host-side work (checkpoint writes, data staging) across a pod.
    """
    if jax.process_count() <= 1:
        return
    from jax.experimental import multihost_utils

    multihost_utils.sync_global_devices(name)
