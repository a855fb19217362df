"""Batched throughput serving over the BatchPipeline.

The deployment shape for fleet workloads (many camera streams, one or more
chips): frame pairs accumulate into fixed-size batches; batch k+1 is
dispatched before batch k's results are read back, so host I/O and device
compute overlap (the double-buffering the reference's single blocking queue
cannot do, ``src/FftMethod.cpp:398``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.parallel.pipeline import BatchPipeline, PipelineOutput


@dataclasses.dataclass
class ServingRequest:
    """One frame pair + its scalar context."""

    prev: np.ndarray  # [H, W] or [H, W, 3]
    curr: np.ndarray
    height: float
    dt: float
    rate_quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0], np.float32)
    )


@dataclasses.dataclass
class ServingResult:
    ok: bool
    tran: np.ndarray  # [3]
    rot: np.ndarray  # [4]
    shifts: np.ndarray  # [P, 2]
    #: log-polar scale / rotation [rad] — real estimates when the pipeline
    #: was built with ``scale_rotation=``, NaN otherwise (PipelineOutput)
    scale: float = float("nan")
    rotation: float = float("nan")


class ServingLoop:
    def __init__(
        self,
        pipeline: BatchPipeline,
        *,
        batch_size: int = 32,
        depth: int = 2,
        c2b_quat=(0.0, 0.0, 0.0, 1.0),
        seed: int = 0,
    ):
        """``depth``: dispatched batches in flight before the oldest is
        read back.  2 = classic double buffering; deeper keeps the device
        working on k+1..k+depth-1 while the host materializes k (the best
        depth on the GPU is not measured yet)."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.pipeline = pipeline
        self.batch_size = batch_size
        self.depth = depth
        self.c2b = jnp.asarray(c2b_quat, jnp.float32)
        self._key = jax.random.PRNGKey(seed)

    def _dispatch(self, batch: List[ServingRequest]):
        b = self.batch_size
        n = len(batch)
        pad = b - n

        def stack(get, dtype=np.float32):
            arr = np.stack([np.asarray(get(r)) if dtype is None else np.asarray(get(r), dtype)
                            for r in batch])
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            return jnp.asarray(arr)

        def norm_frame(a):
            # uint8 capture crosses host->device at a quarter of the bytes
            # of float32 (the engine casts on device); anything else is
            # normalized to float32 on the host — a float64 frame would
            # otherwise double the transfer AND add a per-dtype recompile.
            # Decided per array: a single wide frame in a batch must not
            # promote (or skip normalizing) the rest.
            a = np.asarray(a)
            return a if a.dtype == np.uint8 else np.asarray(a, np.float32)

        def stack_frames(get):
            arrs = [norm_frame(get(r)) for r in batch]
            # a mixed uint8/float batch still needs one dtype: promote to f32
            if any(a.dtype != arrs[0].dtype for a in arrs):
                arrs = [np.asarray(a, np.float32) for a in arrs]
            arr = np.stack(arrs)
            if pad:
                arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)])
            return jnp.asarray(arr)

        prev = stack_frames(lambda r: r.prev)
        curr = stack_frames(lambda r: r.curr)
        heights = stack(lambda r: r.height)
        dts = stack(lambda r: r.dt)
        rates = stack(lambda r: r.rate_quat)
        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, b)
        out = self.pipeline.step(prev, curr, heights, dts, rates, self.c2b, keys)
        return out, n

    @staticmethod
    def _collect(out: PipelineOutput, n: int) -> List[ServingResult]:
        ok = np.asarray(out.ok)[:n]
        tran = np.asarray(out.tran)[:n]
        rot = np.asarray(out.rot)[:n]
        shifts = np.asarray(out.shifts)[:n]
        scale = np.asarray(out.scale)[:n]
        rotation = np.asarray(out.rotation)[:n]
        return [
            ServingResult(ok=bool(ok[i]), tran=tran[i], rot=rot[i],
                          shifts=shifts[i], scale=float(scale[i]),
                          rotation=float(rotation[i]))
            for i in range(n)
        ]

    def run(self, requests: Iterable[ServingRequest]) -> Iterator[ServingResult]:
        """Stream requests through the device with up to ``depth`` batches
        in flight (results still come back in order)."""
        in_flight: List[Tuple[PipelineOutput, int]] = []
        batch: List[ServingRequest] = []

        def flush():
            nonlocal batch
            if not batch:
                return []
            in_flight.append(self._dispatch(batch))  # async: device futures
            batch = []
            if len(in_flight) > self.depth - 1:
                return self._collect(*in_flight.pop(0))  # sync oldest batch
            return []

        for req in requests:
            batch.append(req)
            if len(batch) == self.batch_size:
                yield from flush()
        yield from flush()
        for pending in in_flight:
            yield from self._collect(*pending)
