"""Flow engines (layer L2/L3 of the reference).

The reference exposes one abstract interface, ``OpticFlowCalc``
(``include/OpticFlowCalc.h:6-22``), with four implementations of which one is
live.  All are rebuilt here as batched JAX programs:

=========================================  =================================
reference engine                           here
=========================================  =================================
``FftMethod`` (method 4, live)             :mod:`.fft_method`
``BlockMethod`` (method 3, dormant)        :mod:`.block_method`
``FastSpacedBMMethod`` (method 5, dormant) :mod:`.fast_spaced_bm`
``scaleRotationEstimator`` (disabled)      :mod:`.scale_rotation`
=========================================  =================================

Engines are functional: a frozen config dataclass holds the static
parameters; per-stream state (the previous frame, first-frame flag — the
reference's ``imPrev`` and ``first`` members, ``include/OpticFlowCalc.h:18``,
``src/FftMethod.cpp:1764``) lives in a small pytree threaded through
``step``.  This is what makes the engines jittable, batchable, and shardable
over a device mesh.
"""

from mrs_optic_flow_tpu.models.base import FlowEngine, FlowState, OpticFlowCalc  # noqa: F401
from mrs_optic_flow_tpu.models.fft_method import FftMethod, FftMethodConfig  # noqa: F401
from mrs_optic_flow_tpu.models.block_method import BlockMethod, BlockMethodConfig  # noqa: F401
from mrs_optic_flow_tpu.models.fast_spaced_bm import FastSpacedBM, FastSpacedBMConfig  # noqa: F401
from mrs_optic_flow_tpu.models.scale_rotation import (  # noqa: F401
    ScaleRotationEstimator,
    ScaleRotationConfig,
)


def make_engine(method: int, **kwargs) -> FlowEngine:
    """Method-id dispatch matching the reference's switch
    (``src/optic_flow.cpp:952-1014``): 3 = block matching, 4 = FFT,
    5 = spaced block matching.  Unlike the reference, all three are live."""
    if method == 3:
        return BlockMethod(BlockMethodConfig(**kwargs))
    if method == 4:
        return FftMethod(FftMethodConfig(**kwargs))
    if method == 5:
        return FastSpacedBM(FastSpacedBMConfig(**kwargs))
    raise ValueError(f"invalid method id {method} (expected 3, 4, or 5)")
