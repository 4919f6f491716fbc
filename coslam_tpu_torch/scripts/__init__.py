"""Ports of the JAX package's scripts (`scripts/<name>.py` at the repository
root), one module each under the same file name, run as
`python -m coslam_tpu_torch.scripts.<name>`: `train_vocab` (the offline
vocabulary), `pr_quality` (place-recognition quality), `make_proxy_datasets`
and `run_results` (the dataset CLI over proxy TUM / KITTI / EuRoC
directories) and `debug_coop` (an instrumented two-agent run).  Each runs on
the GPU unless given `--device cpu`."""
