"""The benchmark of primestereomatch_torch, the PyTorch and CUDA port, on
one NVIDIA card: `python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` (see run.py)."""
