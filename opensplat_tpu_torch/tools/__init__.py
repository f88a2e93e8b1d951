"""Tools of the port (microbenches, the synthetic-project writer), run
as `python -m opensplat_tpu_torch.tools.<name>`."""
