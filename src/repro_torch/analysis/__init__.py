"""Cost analysis of a program's run (the port of `repro.analysis`)."""
from .hlo_cost import ProgramCost, analyze_program
__all__ = ["analyze_program", "ProgramCost"]
