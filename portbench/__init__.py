"""The benchmark of ``predictionio_tpu_torch`` on NVIDIA H100 cards: a harness
driven by ``BENCHMARK.json`` and the data files under this folder."""
