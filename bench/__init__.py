"""The benchmark of the PyTorch + CUDA port (``repro_torch``): one cell a
run, ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. See ``bench/harness.py``."""
