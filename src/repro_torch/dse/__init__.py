"""Architecture design-space exploration (the paper's "vast design space
of CGRAs" claim as a first-class subsystem).

The DSE loop mirrors the agile-hardware workflow of the open-CGRA
ecosystem papers: enumerate parameterized :class:`~repro_torch.core.CGRAArch`
variants (``space``), fan the full kernel library across them on the
shared worker pool with content-addressed compile memoization and
resumable checkpointing (``explore``), then score each variant against an
area proxy and report the Pareto frontier (``pareto``).

    from repro_torch.dse import get_space, run_sweep, frontier

    results = run_sweep(get_space("small"))
    best = frontier(results)

Exhaustive sweeps stop paying off past a few hundred points; ``search``
adds seeded multi-objective search (NSGA-II / successive halving) over
the widened ``wide_space`` universe, scored through the batched
cross-architecture evaluator (``evaluate_points``):

    from repro_torch.dse import get_space, run_search, SearchConfig

    res = run_search(get_space("wide"), SearchConfig(algo="nsga2"))

Verification simulates on ``device=`` (``None``: the CUDA card).  CLI
entry points: ``examples/dse_sweep_torch.py --space small`` (sweep) and
``examples/dse_sweep_torch.py --space wide --search nsga2`` (search).
"""
from .space import (ArchPoint, HET_KINDS, SPACE_NAMES, axis_domains,
                    crossover, full_space, get_space, mutate, small_space,
                    tiny_space, wide_space)
from .explore import (KernelOutcome, VariantResult, evaluate_points,
                      kernel_suite, run_sweep, SUITE_KERNELS)
from .search import SEARCH_ALGOS, SearchConfig, SearchResult, run_search
from .pareto import (area_units, frontier, frontier_table, sweep_bench_rows,
                     write_artifacts)

__all__ = [
    "ArchPoint", "HET_KINDS", "SPACE_NAMES", "axis_domains", "crossover",
    "full_space", "get_space", "mutate", "small_space", "tiny_space",
    "wide_space", "KernelOutcome", "VariantResult", "evaluate_points",
    "kernel_suite", "run_sweep", "SUITE_KERNELS", "SEARCH_ALGOS",
    "SearchConfig", "SearchResult", "run_search", "area_units", "frontier",
    "frontier_table", "sweep_bench_rows", "write_artifacts",
]
