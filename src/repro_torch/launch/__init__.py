"""Launchers of the model stack: the step functions (train, serve,
prefill), the serving launcher (`python -m repro_torch.launch.serve`),
the training launcher (`python -m repro_torch.launch.train`), the meshes
(`mesh`), the cells and their lowering (`cells`) and the dry run
(`python -m repro_torch.launch.dryrun`)."""
from .steps import make_prefill_step, make_serve_step, make_train_step
__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]
