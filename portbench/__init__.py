"""The benchmark of the PyTorch/CUDA port (`test_isaacgym_tpu_torch`).

`run.py` runs one cell of the root `BENCHMARK.json` once. Everything a cell
needs is found by name: its configuration (`configs/<config>.json` and its
driver `drivers/<config>.py`), its traffic (`traffic/<traffic>.json`), its
limits (`limits/<workload>.json`) and each metric (`metrics/<name>.py`).
The plain reference that decides `correct` is `reference/`.
"""
