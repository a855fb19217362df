"""Device ops: the JAX equivalents of the reference's OpenCL code.

==============================================  ================================
reference native piece                          equivalent here
==============================================  ================================
``phaseCorrelateField`` (cl/FftMethod.cl:1381)  :mod:`.phase_correlate`
``mulAndNormalizeSpectrums`` (cl:976-1117)      fused into the same graph
``minmaxloc``+``refine`` (cl:1164-1379)         :func:`.phase_correlate.peak_refine`
radix FFT butterflies (cl:29-519)               XLA FFT (cuFFT) / matmul-DFT
``FastSpacedBMMethod.cl`` SAD+histogram         :mod:`.block_matching`
``BlockMethod`` CPU SAD (src/BlockMethod.cpp)   :mod:`.block_matching`
log-polar (src/scaleRotationEstimator.cpp)      :mod:`.logpolar`
host preprocessing (src/optic_flow.cpp:1602)    :mod:`.preprocess`
==============================================  ================================
"""
