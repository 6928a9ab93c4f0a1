"""Worker for tests/test_distributed.py::test_two_process_initialize_and_step.

Spawned twice (process_id 0 and 1), each with 4 virtual CPU devices.
Initializes the JAX distributed runtime through the framework's own
launcher (`parallel.distributed.initialize` via NF_* env vars — the same
arg path a pod launcher uses), builds the global 8-device batch mesh,
runs ONE sharded ELBO train step whose pmean/psum collectives cross the
process boundary, fences with `barrier()`, and prints the replicated
loss + gradient norm for the parent to compare across processes.
"""

import os
import sys

port, pid = sys.argv[1], sys.argv[2]
ckpt_dir = sys.argv[3] if len(sys.argv) > 3 else None

# pure-CPU JAX with 4 local virtual devices, set before JAX is imported so
# the worker never opens a GPU
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["NF_COORDINATOR"] = f"127.0.0.1:{port}"
os.environ["NF_NUM_PROCESSES"] = "2"
os.environ["NF_PROCESS_ID"] = pid

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from normalizingflows.jl_tpu.parallel import distributed  # noqa: E402

distributed.initialize()  # NF_* env path of detect_cluster_env

assert jax.process_count() == 2, jax.process_count()
assert distributed.is_multi_host()
assert distributed.host_index() == int(pid)
assert len(jax.local_devices()) == 4, len(jax.local_devices())
assert len(jax.devices()) == 8, len(jax.devices())

import optax  # noqa: E402

import normalizingflows as nf  # noqa: E402
from normalizingflows.jl_tpu.parallel.mesh import batch_mesh  # noqa: E402
from normalizingflows.jl_tpu.parallel.sharded import (  # noqa: E402
    shard_objective,
)
from normalizingflows.jl_tpu.utils.pytree import global_norm  # noqa: E402

mesh = batch_mesh()  # all 8 devices, spanning both processes
target = nf.Banana(2, 1.0, 10.0)
vo = shard_objective(nf.elbo_batch, mesh)
optimizer = optax.adam(1e-2)


@jax.jit
def one_step(build_key, sample_key):
    # construct the flow inside jit: small replicated outputs, no
    # host-local committed arrays to disagree across processes
    flow = nf.realnvp(build_key, 2, (8, 8), nlayers=2)

    def loss_fn(f):
        return -vo(sample_key, f, target.log_prob, 64)

    loss, grads = jax.value_and_grad(loss_fn)(flow)
    updates, _ = optimizer.update(grads, optimizer.init(flow), flow)
    new_flow = optax.apply_updates(flow, updates)
    loss2 = loss_fn(new_flow)
    return loss, global_norm(grads), loss2


loss, gnorm, loss2 = one_step(jax.random.key(0), jax.random.key(1))
loss, gnorm, loss2 = float(loss), float(gnorm), float(loss2)

distributed.barrier()
print(f"RESULT {loss:.10f} {gnorm:.10f} {loss2:.10f}", flush=True)

if ckpt_dir:
    # Multi-host checkpoint exercise (VERDICT r4 item 6b): orbax-save a
    # replicated flow + a GLOBAL mesh-sharded array (each process holds 4
    # of its 8 shards), barrier, templated restore, and verify both kinds
    # of state agree with what was saved — executing the "multi-host
    # path" claim of utils/checkpoint.py rather than asserting it.
    import numpy as np  # noqa: E402
    from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

    from normalizingflows.jl_tpu.utils.checkpoint import (  # noqa: E402
        load_pytree,
        save_pytree,
    )

    jnp = jax.numpy
    sh = NamedSharding(mesh, P("batch"))
    # globally-consistent values, distributed shard-wise: process-local
    # host buffers feed make_array_from_callback so no single process
    # ever holds the full array
    full = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    data = jax.make_array_from_callback(
        full.shape, sh, lambda idx: full[idx])
    flow = jax.jit(lambda k: nf.realnvp(k, 2, (8, 8), nlayers=2))(
        jax.random.key(0))

    save_pytree(ckpt_dir, {"flow": flow, "data": data}, backend="orbax")
    distributed.barrier()

    template = {
        "flow": jax.jit(lambda k: nf.realnvp(k, 2, (8, 8), nlayers=2))(
            jax.random.key(42)),
        "data": jax.make_array_from_callback(
            full.shape, sh, lambda idx: np.zeros_like(full[idx])),
    }
    restored = load_pytree(ckpt_dir, template, backend="orbax")

    # sharded leaf: every LOCAL shard must hold the saved global values
    for shard in restored["data"].addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), full[shard.index])
    assert restored["data"].sharding.is_equivalent_to(sh, data.ndim)
    # replicated flow leaves: bitwise equal to the saved flow
    checksum = 0.0
    for a, b in zip(jax.tree_util.tree_leaves(restored["flow"]),
                    jax.tree_util.tree_leaves(flow)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        checksum += float(np.sum(np.asarray(a)))
    distributed.barrier()
    print(f"CKPT {checksum:.10f}", flush=True)
