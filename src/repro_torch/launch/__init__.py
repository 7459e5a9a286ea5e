"""Launchers of the model stack: the serving step functions and the
serving launcher (`python -m repro_torch.launch.serve`)."""
