"""Probe tools of the port: the counterparts of the JAX package's tools/
probes, run as `python -m textualdegremoval_tpu_torch.tools.<name>`."""
