"""Tools of the port: microbenches run as `python -m
opensplat_tpu_torch.tools.<name>`."""
