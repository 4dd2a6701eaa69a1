"""The benchmark of keypoints_tpu_torch on NVIDIA H100 cards.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. It imports neither ``jax`` nor the JAX package.
"""
