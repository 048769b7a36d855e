"""gravomg_tpu: a geometric multigrid framework in JAX.

A ground-up JAX rebuild of the capabilities of
`JacksonCampolattaro/gravo-mg` (hierarchy construction for Gravo MG,
SIGGRAPH 2023) plus the solver stack the method drives (V-cycles,
weighted-Jacobi/Chebyshev smoothing, Galerkin RAP, MG-preconditioned CG,
dense coarse Cholesky).  Everything is fixed-shape, masked, padded array
code that traces once under jit and scales via vmap/pjit.

Quick start::

    import jax.numpy as jnp
    from gravomg_tpu import (knn_graph, poisson_hierarchy,
                             MultigridConfig, solve_poisson)

    graph = knn_graph(points, k=32)
    # L + 0.5*diag(mass): the SPD screened-Poisson operator (a pure
    # graph Laplacian is singular -- its constant nullspace caps f32
    # convergence near 1e-7).
    h = poisson_hierarchy(graph, alpha=0.5, cfg=MultigridConfig())
    x, rel, iters = solve_poisson(h, b)      # MG-preconditioned CG
"""

from gravomg_tpu.types import (EllOperator, Graph, HierarchyStats,
                               Prolongation, Restriction, TriangleSet,
                               INVALID_INDEX)
from gravomg_tpu.config import MultigridConfig
from gravomg_tpu.geometry.transforms import scale_mesh
from gravomg_tpu.geometry.knn import knn_graph, graph_from_edges
from gravomg_tpu.geometry.gridknn import grid_knn_graph
from gravomg_tpu.geometry.laplacian import (cotan_laplacian, extract_edges,
                                            graph_laplacian,
                                            to_edge_distance_graph)
from gravomg_tpu.coarsen.sampling import (average_edge_length,
                                          fast_disc_sample,
                                          fast_disc_sample_mask,
                                          sampling_radius)
from gravomg_tpu.coarsen.parents import assign_parents
from gravomg_tpu.coarsen.graph import coarse_graph, extract_coarse_edges
from gravomg_tpu.coarsen.placement import coarse_from_mean_of_fine_children
from gravomg_tpu.prolong.triangles import construct_voronoi_triangles
from gravomg_tpu.prolong.operator import (BARYCENTRIC, INVDIST, UNIFORM,
                                          build_restriction,
                                          construct_prolongation,
                                          projected_points, prolong,
                                          restrict, restrict_gather)
from gravomg_tpu.solve.spmv import spmv, residual
from gravomg_tpu.solve.rap import galerkin_rap
from gravomg_tpu.solve.smoothers import (ChebyshevParams, chebyshev,
                                         weighted_jacobi)
from gravomg_tpu.solve.vcycle import (SolverHierarchy, SolverLevel,
                                      attach_fast_operators,
                                      attach_operators,
                                      attach_restrictions,
                                      attach_slab_operators,
                                      cast_fast_operators, fmg,
                                      level_matvec, solve, solve_refined,
                                      solve_with_history, v_cycle)
from gravomg_tpu.solve.cg import fcg, mg_fcg, mg_pcg, mg_solve, pcg
from gravomg_tpu.hierarchy import (Hierarchy, LevelData, build_hierarchy,
                                   coarsen_once)
from gravomg_tpu.hierarchy_static import (LevelDiagnostics,
                                          build_hierarchy_device,
                                          check_diagnostics, compact_solver)
from gravomg_tpu.apps import (heat_geodesics, implicit_smooth, laplace_eigs,
                              poisson_hierarchy, refit_hierarchy,
                              screened_poisson_operator, solve_poisson)
from gravomg_tpu.io.serialization import load_solver, save_solver
from gravomg_tpu.parallel.batch import (batched_solve, batched_v_cycle,
                                        stack_solvers)
from gravomg_tpu.parallel.sharding import (make_mesh, pad_solver_levels,
                                           shard_solver, sharded_solve)

__version__ = "0.1.0"
