"""rcppml_tpu — a JAX matrix-factorization framework.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
RcppML/FactorNet reference: ALS-NMF with six IRLS distributions,
zero-inflation, rich regularization, speckled-holdout CV with automatic rank
search, five truncated-SVD algorithms, rank-2 divisive clustering, a
composable multi-layer factor-graph engine, and sharded multi-chip
execution over a ``jax.sharding.Mesh``.
"""

def _setup_compilation_cache():
    """Enable JAX's persistent compilation cache.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as it stands (JAX
    reads it itself).  Otherwise the cache lives at the fixed path
    ``<checkout>/.jax_cache``: the path is part of what makes a later
    process find an entry again, so it must not move between runs."""
    import os as _os
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return
    import jax as _jax
    if _jax.config.jax_compilation_cache_dir:
        return
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    _jax.config.update("jax_compilation_cache_dir",
                       _os.path.join(root, ".jax_cache"))


_setup_compilation_cache()

from .api import nmf, build_config
from .config import (Dispersion, FactorConfig, Loss, NMFConfig, Norm, Solver,
                     SVDConfig, ZI)
from .result import NMFResult, SVDResult

__version__ = "0.1.0"

__all__ = [
    "nmf", "build_config",
    "NMFConfig", "FactorConfig", "SVDConfig",
    "Loss", "Dispersion", "ZI", "Norm", "Solver",
    "NMFResult", "SVDResult",
]


# Lazy accessor table: every reference NAMESPACE export (NAMESPACE:30-111)
# resolves at the package top level, but `import rcppml_tpu` stays light.
# Values are (module, attr); attr None means same name.
_LAZY = {
    # core algorithms
    "svd": (".models.svd", None), "pca": (".models.svd", None),
    "bipartition": (".models.clustering", None),
    "dclust": (".models.clustering", None),
    "consensus_nmf": (".models.clustering", None),
    "bipartiteMatch": (".models.clustering", "bipartite_match"),
    "bipartite_match": (".models.clustering", None),
    "align": (".models.clustering", "align_factors"),
    "nnls": (".models.project", None), "predict": (".models.project", None),
    "evaluate": (".models.project", None), "mse": (".models.project", None),
    # factor-graph engine (R/factor_net.R surface)
    "factor_input": (".models.graph", None),
    "factor_shared": (".models.graph", None),
    "factor_concat": (".models.graph", None),
    "factor_add": (".models.graph", None),
    "factor_condition": (".models.graph", None),
    "factor_config": (".models.graph", None),
    "nmf_layer": (".models.graph", None),
    "svd_layer": (".models.graph", None),
    "factor_net": (".models.graph", None),
    "fit": (".models.graph", None),
    "cross_validate_graph": (".models.graph", None),
    "W": (".models.graph", None), "H": (".models.graph", None),
    "GlobalConfig": (".models.graph", None),
    # diagnostics + assessment + classifiers
    "auto_nmf_distribution": (".utils.diagnostics", None),
    "score_test_distribution": (".utils.diagnostics", None),
    "diagnose_zero_inflation": (".utils.diagnostics", None),
    "diagnose_dispersion": (".utils.diagnostics", None),
    "assess": (".utils.metrics", None),
    "cosine": (".utils.metrics", None),
    "classify_embedding": (".utils.metrics", None),
    "classify_logistic": (".utils.metrics", None),
    "classify_rf": (".utils.metrics", None),
    # guided NMF
    "compute_target": (".utils.guided", None),
    "refine": (".utils.guided", None),
    # simulation (R camelCase + python names)
    "simulateNMF": (".utils.simulate", "simulate_nmf"),
    "simulateSwimmer": (".utils.simulate", "simulate_swimmer"),
    "simulate_nmf": (".utils.simulate", None),
    "simulate_swimmer": (".utils.simulate", None),
    # training log + plots
    "training_logger": (".utils.training_log", None),
    "export_log": (".utils.training_log", None),
    "compare_nmf": (".utils.plots", None),
    "biplot": (".utils.plots", None),
    "plot_nmf": (".utils.plots", None),
    "plot_cv": (".utils.plots", None),
    "plot_dclust": (".utils.plots", None),
    "plot_consensus": (".utils.plots", None),
    "plot_summary": (".utils.plots", None),
    # streaming SVD over a DataLoader / .spz path (svd/streaming.hpp)
    "streaming_svd": (".models.svd", None),
    # RNG surface (R/random.R)
    "r_matrix": (".rng", None), "r_sparsematrix": (".rng", None),
    "r_sample": (".rng", None), "r_unif": (".rng", None),
    "r_binom": (".rng", None),
    # parallel / logging / device introspection (gpu_available/gpu_info
    # analogs, R/gpu_backend.R:68-143)
    "default_mesh": (".parallel.mesh", None),
    "tpu_available": (".utils.resources", None),
    "tpu_info": (".utils.resources", None),
    "accelerator_available": (".utils.resources", "tpu_available"),
    "accelerator_info": (".utils.resources", "tpu_info"),
    # literal-name compat aliases so reference scripts run unmodified
    # (the last 4 NAMESPACE exports without same-name analogs; the
    # accelerator here IS the JAX backend)
    "gpu_available": (".utils.resources", "tpu_available"),
    "gpu_info": (".utils.resources", "tpu_info"),
    "st_read_gpu": (".io.spz", "st_read_device"),
    "st_free_gpu": (".io.spz", "st_free_device"),
    "st_free_device": (".io.spz", None),
    "set_verbosity": (".utils.logging", None),
    "get_verbosity": (".utils.logging", None),
    "LogLevel": (".utils.logging", None),
    # datasets namespace
    "datasets": (".datasets", "__module__"),
}

# the whole streampress st_* surface rides through io.spz
_ST_NAMES = (
    "st_write", "st_read", "st_read_transpose", "st_info", "st_write_dense",
    "st_read_dense", "st_read_auto", "st_add_transpose", "st_convert",
    "st_read_obs", "st_read_var", "st_read_dimnames",
    "st_write_with_metadata", "st_chunk_ranges", "st_slice_cols",
    "st_slice_rows", "st_slice", "st_map_chunks", "st_obs_indices",
    "st_filter_cols", "st_filter_rows", "st_write_list", "st_read_device")


def __getattr__(name):
    import importlib
    if name in _ST_NAMES:
        mod = importlib.import_module(".io.spz", __name__)
        return getattr(mod, name)
    if name in _LAZY:
        modname, attr = _LAZY[name]
        mod = importlib.import_module(modname, __name__)
        if attr == "__module__":
            return mod
        return getattr(mod, attr or name)
    if name in ("reconstruct", "sparsity", "variance_explained"):
        # R generics: free functions delegating to the result object
        def _generic(obj, *a, **kw):
            return getattr(obj, name)(*a, **kw)
        _generic.__name__ = name
        return _generic
    raise AttributeError(f"module 'rcppml_tpu' has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(_LAZY) | set(_ST_NAMES)
                  | {"reconstruct", "sparsity", "variance_explained"})
