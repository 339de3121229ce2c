"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one
command runs one cell once (``python3 flexbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``).  See README.md."""
