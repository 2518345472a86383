"""The port's counterparts of the reference's paper benchmarks
(``benchmarks/``): the same CLI flags and ``#csv`` blocks, plus
``--device`` (default the GPU).  ``run`` is the harness.

    python -m repro_torch.benchmarks.run [--full] [--only NAME] [--list]
    python -m repro_torch.benchmarks.<name> [--full] [--device cpu]

Registered: fig3_offsets, table1, fig5_frac_sensitivity, fig6_reliability,
calibration_convergence, fleet_calibration, kernel_bench (``kernels``),
kernel_microbench, mvdram_serving (``serving``), drift_recovery,
majx_general, placement.
"""
