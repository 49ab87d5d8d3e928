"""The benchmark of ``dronerl_tpu_torch``, the port's training on one
NVIDIA H100: ``python3 -m portbench.run`` (see ``run.py``). Everything a
cell needs is found by name: ``configs/``, ``traffic/``, ``limits/``,
``metrics/``, ``engines/`` (what is read from the program's carry) and
``reference/`` (the plain PyTorch reference that decides ``correct``)."""
