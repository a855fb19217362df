"""mrs_optic_flow_tpu — optical-flow velocity estimation framework on JAX/XLA.

A from-scratch JAX/XLA rebuild of the capabilities of ctu-mrs/mrs_optic_flow
(a ROS nodelet estimating UAV metric velocity from a downward-facing camera
via multi-patch FFT phase correlation, accelerated by a fused OpenCL
kernel), running on an NVIDIA GPU:

- the fused per-patch FFT -> cross-power -> peak -> centroid chain of
  ``cl/FftMethod.cl:1381`` (phaseCorrelateField) becomes one jit-compiled
  batched graph over a ``[P, S, S]`` patch tensor (XLA FFTs or matmul
  DFTs) that XLA fuses;
- the radix plan machinery (``src/FftMethod.cpp:215-565``) is replaced by the
  XLA compilation cache — plans are compile-time, keyed by shape;
- host<->GPU OpenCL queue plumbing becomes host->device feeds with donated
  buffers and a batched throughput mode sharded over a ``jax.sharding.Mesh``.

Layer map (mirrors SURVEY.md section 1):

====================  =====================================================
reference layer       this package
====================  =====================================================
L5 node / IO          :mod:`mrs_optic_flow_tpu.runtime`
L4 geometry           :mod:`mrs_optic_flow_tpu.geometry`
L3 method interface   :mod:`mrs_optic_flow_tpu.models.base`
L2 flow engines       :mod:`mrs_optic_flow_tpu.models`
L1 device kernels     :mod:`mrs_optic_flow_tpu.ops`
filters/utilities     :mod:`mrs_optic_flow_tpu.filters`
config                :mod:`mrs_optic_flow_tpu.config`
parallel/scaling      :mod:`mrs_optic_flow_tpu.parallel`
====================  =====================================================
"""

__version__ = "0.1.0"


def __getattr__(name):
    """Lazy top-level conveniences (keep `import mrs_optic_flow_tpu` light —
    importing the package must not pull jax in; `--help` and config-only
    callers never pay the multi-second device-stack import)."""
    if name in ("phase_correlate_field", "correlation_surface", "peak_refine"):
        import mrs_optic_flow_tpu.ops.phase_correlate as pc

        return getattr(pc, name)
    if name in ("FftMethod", "FftMethodConfig", "BlockMethod", "FastSpacedBM",
                "ScaleRotationEstimator", "OpticFlowCalc", "make_engine"):
        import mrs_optic_flow_tpu.models as m

        return getattr(m, name)
    if name in ("OpticFlowNode", "FrameStream", "SyntheticScene", "FleetServer"):
        import mrs_optic_flow_tpu.runtime as r

        return getattr(r, name)
    if name in ("BatchPipeline", "make_mesh"):
        import mrs_optic_flow_tpu.parallel as p

        return getattr(p, name)
    if name == "ServingLoop":
        from mrs_optic_flow_tpu.runtime.serving import ServingLoop

        return ServingLoop
    if name == "load_config":
        from mrs_optic_flow_tpu.config import load_config

        return load_config
    raise AttributeError(name)
