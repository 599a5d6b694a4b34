"""cfdbench: the benchmark of mgcfd_tpu_torch, the PyTorch and CUDA port.

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix) on the card:

    python3 -m cfdbench.run --workload m6rcm.graph --seed 7 --seconds 10 --trace 0

The harness is driven by data. A configuration is configs/<name>.json, a
mix is mixes/<name>.json, and each per-layer metric is a reader
metrics/<name>.py; run.py finds each by the name BENCHMARK.json gives.
Where a configuration has the port renumber its mesh on load, order.py
maps the port's node order to the files' by the node coordinates.

Nothing here imports jax or the JAX package. inputs/ (the meshes),
reference/ (the plain fp64 V-cycle), counts.py (bytes and operations) and
check.py (the comparison) import nothing of the port either: they are the
yardstick the port is held to.
"""
