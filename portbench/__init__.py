"""The benchmark of the PyTorch and CUDA port (``stylish_tts_tpu_torch``)
on NVIDIA cards: ``python3 -m portbench.run --workload NAME --seed N
--seconds S --trace 0|1`` runs one cell of ``BENCHMARK.json`` once."""
