"""The benchmark of ``cs744_ddp_tpu_torch`` on NVIDIA H100s: training
images a second of the CS744 classifiers, with the plain reference that
decides whether a run is correct.  See README.md."""
