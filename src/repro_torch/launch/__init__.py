"""Launchers of the model stack: the step functions (train, serve,
prefill), the serving launcher (`python -m repro_torch.launch.serve`) and
the training launcher (`python -m repro_torch.launch.train`)."""
