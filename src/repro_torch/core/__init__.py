"""Core library of the PyTorch/CUDA port: the Weight Balanced p-way
Vertex Cut pipeline, with the public names of the JAX package's
`repro.core`.

Public API:
  IRGraph                      — weighted dataflow graph (LLVM-graph analogue)
  from_reference_arrays        — an IRGraph over another package's arrays
  vertex_cut / ALGORITHMS      — the 6 greedy cuts + random (paper §4)
  edge_cut / EDGE_CUT_METHODS  — CompNet + METIS-like baselines (paper §6.1)
  memory_centric_mapping       — Algorithm 2 cluster→core scheduling
  simulate / run_pipeline      — NUMA multicore cost simulation (paper §6)
  plan_graph / PlanReport      — cut → map → simulate as one plan
  build_graph / BENCHMARKS     — the paper's 10 traced benchmarks (Table 3)
  expected_replication_random  — Eq. (10) theory

Backends: "cuda", the default of every entry point, runs the reductions
on `device=` ("cuda", the card, by default; "cpu" for the kernels'
plain versions); "reference", "fast", "native" and "python" are the host
engines, which ignore `device=`.
"""
from .graph import IRGraph, from_reference_arrays
from .powerlaw import (expected_replication_random,
                       expected_replication_random_empirical,
                       synthesize_powerlaw_graph, zipf_degrees)
from .vertex_cut import (ALGORITHMS, BACKENDS, ShardCutState,
                         VertexCutResult, resolve_backend, vertex_cut)
from .edge_cut import EDGE_CUT_METHODS, EdgeCutResult, edge_cut
from .mapping import (MAPPING_BACKENDS, Machine, MappingResult,
                      cluster_interaction_graphs, memory_centric_mapping,
                      resolve_mapping_backend, round_robin_mapping)
from .simulator import (SimReport, coerce_graph, run_pipeline, simulate,
                        vertex_bytes_model)
from .planner import PlanReport, plan_graph
from .benchgraphs import BENCHMARKS, Tracer, all_benchmark_names, build_graph

__all__ = [
    "IRGraph", "from_reference_arrays", "vertex_cut", "VertexCutResult",
    "ALGORITHMS", "BACKENDS", "resolve_backend", "ShardCutState",
    "edge_cut", "EdgeCutResult", "EDGE_CUT_METHODS",
    "Machine", "MappingResult", "memory_centric_mapping",
    "round_robin_mapping", "cluster_interaction_graphs",
    "MAPPING_BACKENDS", "resolve_mapping_backend",
    "SimReport", "simulate", "run_pipeline", "vertex_bytes_model",
    "coerce_graph", "PlanReport", "plan_graph",
    "BENCHMARKS", "Tracer", "all_benchmark_names", "build_graph",
    "expected_replication_random", "expected_replication_random_empirical",
    "synthesize_powerlaw_graph", "zipf_degrees",
]
