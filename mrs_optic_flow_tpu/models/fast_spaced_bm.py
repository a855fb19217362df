"""FastSpacedBMMethod — spaced-grid SAD + on-device histogram vote
(method 5, dormant in the reference).

Rebuild of the OpenCL pair ``OptFlow_C1_D0`` + ``Histogram_C1_D0``
(``src/FastSpacedBMMethod.cl:4-169``) and their host driver
(``src/FastSpacedBMMethod_OCL.cpp:74-184``): SAD search on a grid spaced by
``sample_point_size + step_size``, flat-area rejection, then a histogram
vote whose top-``TestDepth`` x/y values form candidate vectors; the
published output is the single most-voted vector
(``src/FastSpacedBMMethod_OCL.cpp:178-180``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from mrs_optic_flow_tpu.models.base import FlowEngine, FlowResult, FlowState
from mrs_optic_flow_tpu.ops.block_matching import (
    _extract_blocks,
    histogram_vote,
    sad_min_flow,
    sad_search,
)


@dataclasses.dataclass(frozen=True)
class FastSpacedBMConfig:
    frame_size: int = 480
    sample_point_size: int = 120  # blockSize
    scan_radius: int = 21
    step_size: int = 24  # blockStep (grid pitch = size + step)
    test_depth: int = 3  # TestDepth (src/FastSpacedBMMethod_OCL.cpp:100)


class FastSpacedBM(FlowEngine):
    def __init__(self, config: FastSpacedBMConfig = FastSpacedBMConfig()):
        self.config = config
        c = config
        pitch = c.sample_point_size + c.step_size
        #: grid = (cols - 2R) / pitch (src/FastSpacedBMMethod_OCL.cpp:88)
        self.grid_side = (c.frame_size - 2 * c.scan_radius) // pitch
        self.num_cells = self.grid_side * self.grid_side
        i = np.arange(self.grid_side)
        # block origin: blockX * pitch + scanRadius (src/FastSpacedBMMethod.cl:28-31)
        xs, ys = np.meshgrid(i * pitch + c.scan_radius, i * pitch + c.scan_radius)
        self._origins = np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(np.int32)

    def init_state(self) -> FlowState:
        c = self.config
        return FlowState(
            prev=jnp.zeros((c.frame_size, c.frame_size), jnp.float32),
            first=jnp.asarray(True),
        )

    @functools.partial(jax.jit, static_argnames=("self",))
    def step(self, state: FlowState, frame: jnp.ndarray) -> Tuple[FlowState, FlowResult]:
        c = self.config
        curr = jnp.asarray(frame, jnp.float32)
        prev = jnp.where(state.first, curr, state.prev)

        origins = jnp.asarray(self._origins)
        curr_blocks = _extract_blocks(curr, origins, c.sample_point_size)
        region = c.sample_point_size + 2 * c.scan_radius
        prev_regions = _extract_blocks(prev, origins - c.scan_radius, region)
        sad = sad_search(
            curr_blocks, prev_regions,
            block_size=c.sample_point_size, scan_radius=c.scan_radius,
        )
        # flat-area -> (0, 0): MinValThreshold = scanRadius^2 * 0.2
        # (src/FastSpacedBMMethod.cl:2, :79-84)
        cell_flow = sad_min_flow(
            sad, c.scan_radius, noise_threshold=c.scan_radius**2 * 0.2
        )
        top_x, top_y = histogram_vote(cell_flow, c.scan_radius, top_k=c.test_depth)
        # candidate vectors are the TestDepth x TestDepth (x, y) combinations
        # (src/FastSpacedBMMethod.cl:154-163); only combo (0, 0) is published
        cands = jnp.stack(
            jnp.meshgrid(top_x, top_y, indexing="ij"), axis=-1
        ).reshape(-1, 2)

        new_state = FlowState(prev=curr, first=jnp.asarray(False))
        # sign normalized from SAD prev-offset to content motion, matching
        # the FlowEngine convention (see BlockMethod.step)
        return new_state, FlowResult(
            shifts=-cands[:1].astype(jnp.float32),
            shifts_raw=-cell_flow.astype(jnp.float32),
            response=jnp.zeros((1,), jnp.float32),
        )

    def __hash__(self):
        return hash(self.config)

    def __eq__(self, other):
        return isinstance(other, FastSpacedBM) and self.config == other.config
