"""Experiments and measurements of the port.

On the card: ``skew_bench`` (direct against hot/cold lookups on zipf ids),
the kernel sweeps (``int8_sweep``, ``k3b_sweep``, ``k5_sweep``,
``k6_sweep``, built by ``sweep_build``), ``sweep`` (the card's latency
ladders, ``characterization/gpu_<model>.json``), ``op_breakdown`` (time
by stage and by kernel). The JAX package's experiments: ``qps_sweep``
(latency-bounded QPS on ``gpu``, ``cpu`` or ``calibrated-sim``),
``scheduling_study`` and ``loadgen_study`` (on ``sim`` by default),
``train_quality`` (a planted signal learned by the sparse trainer) and
``plots`` (their figures).
"""
