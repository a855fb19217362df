"""Device-mesh utilities: batch-sharded flow steps.

Design: frame-pair batches shard over a 1-D ``data`` mesh axis; every patch
correlation is independent, so XLA inserts no communication on the hot path
(the right answer for a workload whose math has no cross-sample coupling).
Observability reductions (fleet mean/max shift magnitudes) are all-reduces
over the mesh — NVLink between the GPUs of one host, which joins every card
to every other, so a 1-D axis needs no topology-aware layout.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data") -> Mesh:
    """1-D device mesh over the first ``n_devices`` devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


def shard_batch(x: jnp.ndarray, mesh: Mesh, axis_name: str = "data") -> jnp.ndarray:
    """Place a batch-leading array with its leading dim sharded over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P(axis_name)))


def sharded_flow_step(engine, mesh: Mesh, axis_name: str = "data"):
    """Batch-sharded throughput step with a fleet-statistics collective.

    Returns a jitted ``fn(prev [B, H, W], curr [B, H, W]) ->
    (shifts [B, P, 2], fleet_mean_speed [])`` where B shards over the mesh.
    The scalar fleet statistic forces a real all-reduce across devices —
    the one collective of a throughput deployment.
    """
    in_sharding = NamedSharding(mesh, P(axis_name))
    out_sharding = (NamedSharding(mesh, P(axis_name)), NamedSharding(mesh, P()))

    def step(prev, curr):
        res = engine.step_batch(prev, curr)
        speed = jnp.linalg.norm(res.shifts_raw, axis=-1)
        return res.shifts, jnp.mean(speed)

    return jax.jit(
        step,
        in_shardings=(in_sharding, in_sharding),
        out_shardings=out_sharding,
    )
