"""FactorNet graph engine — composable multi-layer factorization DAGs.

JAX equivalent of ``inst/include/FactorNet/graph/`` and the R front-end
``R/factor_net.R:42-508``.  Node types (graph/node.hpp:47-56): INPUT,
NMF_LAYER, SVD_LAYER, SHARED, CONCAT, ADD, CONDITION.

Execution (graph/fit.hpp):
  * single layer -> delegate to the full NMF engine (sharded/IRLS/CV all
    available);
  * multi-layer -> outer ALS (fit.hpp:265-355): warmup fits per layer, then
    per-layer single-iteration sweeps warm-started from the current W, until
    the summed per-layer reconstruction loss converges.  Where the reference
    re-enters the full ``nmf()`` gateway once per layer per sweep, this
    path compiles the ENTIRE outer ALS (all layers, all sweeps, the
    convergence test and the per-layer Gram-trick losses) into one
    ``lax.while_loop`` executable — zero host round-trips per sweep — and
    falls back to the host-driven loop only for IRLS losses or CV holdouts;
  * SHARED multi-modal inputs are row-concatenated before fitting and W is
    split back into per-input row blocks (R/factor_methods.R:152-221);
  * deeper layers factorize t(H) of their upstream layer
    (fit.hpp:95-175); CONCAT row-binds branch t(H)s, ADD sums branch Hs,
    CONDITION appends covariate columns.
"""

from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..config import FactorConfig
from ..result import NMFResult

_counter = itertools.count()


class Node:
    kind = "node"

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{self.kind}_{next(_counter)}"


class Input(Node):
    kind = "input"

    def __init__(self, data, name: Optional[str] = None):
        super().__init__(name)
        if isinstance(data, str):
            # .spz path input (R factor_input file routing,
            # test_factor_net.R:406-447): decoded through the native
            # codec; the graph engine then runs its dense fused path
            import os as _os
            if not data.endswith(".spz"):
                raise ValueError(f"factor_input path must be .spz: {data!r}")
            if not _os.path.exists(data):
                raise ValueError(f"no such .spz file: {data!r}")
            from ..io.spz import st_read
            from ..utils.memory import guard_dense_input
            sp_mat = st_read(data)
            guard_dense_input(sp_mat.shape[0], sp_mat.shape[1])
            data = np.asarray(sp_mat.todense(), dtype=np.float32)
        self.data = data


class Shared(Node):
    """Shared-H multi-modal input: row-concat of 2+ inputs with the same
    number of columns (samples)."""
    kind = "shared"

    def __init__(self, *inputs: Input, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_shared requires at least 2 inputs")
        self.inputs = list(inputs)


class Concat(Node):
    kind = "concat"

    def __init__(self, *inputs: Node, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_concat requires at least 2 inputs")
        self.inputs = list(inputs)


class Add(Node):
    kind = "add"

    def __init__(self, *inputs: Node, name=None):
        super().__init__(name)
        if len(inputs) < 2:
            raise ValueError("factor_add requires at least 2 inputs")
        self.inputs = list(inputs)


class Condition(Node):
    """Append covariate columns Z to the layer input (batch conditioning)."""
    kind = "condition"

    def __init__(self, input: Node, Z, name=None):
        super().__init__(name)
        self.input = input
        self.Z = np.asarray(Z, dtype=np.float32)


class NMFLayer(Node):
    kind = "nmf_layer"

    def __init__(self, input: Node, k: int, *, name=None, W: Optional[dict] = None,
                 H: Optional[dict] = None, loss: str = "mse", **fit_kwargs):
        super().__init__(name)
        self.input = input
        self.k = int(k)
        self.W = W or {}
        self.H = H or {}
        self.loss = loss
        self.fit_kwargs = fit_kwargs


class SVDLayer(Node):
    kind = "svd_layer"

    def __init__(self, input: Node, k: int, *, name=None, **fit_kwargs):
        super().__init__(name)
        self.input = input
        self.k = int(k)
        self.fit_kwargs = fit_kwargs


# R-style constructor aliases (R/factor_net.R:42-508)
factor_input = Input
factor_shared = Shared
factor_concat = Concat
factor_add = Add
factor_condition = Condition
nmf_layer = NMFLayer
svd_layer = SVDLayer


# ---------------------------------------------------------------------------
# Global network config (R/factor_net.R:126-158 factor_config ->
# fn_global_config)
# ---------------------------------------------------------------------------

_LOSSES = ("mse", "gp", "nb", "gamma", "inverse_gaussian", "tweedie")


@dataclass
class GlobalConfig:
    """Network-wide fit settings (``fn_global_config``).

    ``dots`` are forwarded to the underlying ``nmf()`` call at fit time as
    lowest-priority defaults — layer-level kwargs override them
    (R/factor_net.R:103-108)."""
    maxit: int = 100
    tol: float = 1e-4
    loss: str = "mse"
    verbose: bool = False
    seed: Optional[int] = None
    norm: str = "L1"
    solver: str = "auto"
    test_fraction: float = 0.0
    cv_seed: int = 0
    mask_zeros: bool = False
    patience: int = 5
    dots: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.loss not in _LOSSES:
            raise ValueError(f"loss must be one of {_LOSSES}")
        if not (0.0 <= self.test_fraction < 1.0):
            raise ValueError("test_fraction must be in [0, 1)")

    def replace(self, **kw) -> "GlobalConfig":
        import dataclasses
        return dataclasses.replace(self, **kw)


def factor_config(maxit: int = 100, tol: float = 1e-4, loss: str = "mse",
                  verbose: bool = False, seed: Optional[int] = None,
                  norm: str = "L1", solver: str = "auto",
                  test_fraction: float = 0.0, cv_seed: int = 0,
                  mask_zeros: bool = False, patience: int = 5,
                  **dots) -> GlobalConfig:
    """Global network config (R/factor_net.R:126 ``factor_config()``).

    Extra keyword args land in ``dots`` and are forwarded network-wide to
    every layer's ``nmf()``/``svd()`` call as lowest-priority defaults."""
    return GlobalConfig(maxit=int(maxit), tol=float(tol), loss=loss,
                        verbose=bool(verbose), seed=seed, norm=norm,
                        solver=solver, test_fraction=float(test_fraction),
                        cv_seed=int(cv_seed), mask_zeros=bool(mask_zeros),
                        patience=int(patience), dots=dict(dots))


_SIDE_KEYS = {"L1", "L2", "L21", "angular", "upper_bound", "nonneg",
              "graph", "graph_lambda", "target", "target_lambda"}


def _side_config(**kw) -> dict:
    """Per-side factor config builder (R/factor_net.R ``W()``/``H()``)."""
    bad = set(kw) - _SIDE_KEYS
    if bad:
        raise ValueError(f"unknown factor-config keys {sorted(bad)}; "
                         f"valid: {sorted(_SIDE_KEYS)}")
    return dict(kw)


def W(**kw) -> dict:
    """R-style W-side config: ``nmf_layer(x, k, W=W(L1=0.1))``."""
    return _side_config(**kw)


def H(**kw) -> dict:
    """R-style H-side config: ``nmf_layer(x, k, H=H(L2=0.01))``."""
    return _side_config(**kw)


@dataclass
class LayerResult:
    W: np.ndarray
    d: np.ndarray
    H: np.ndarray
    iterations: int = 0
    loss: float = float("nan")
    test_loss: float = float("nan")
    best_test_loss: float = float("nan")
    converged: bool = False
    W_blocks: Optional[Dict[str, np.ndarray]] = None   # shared inputs: split W


@dataclass
class GraphResult:
    layers: Dict[str, LayerResult] = field(default_factory=dict)
    total_iterations: int = 0
    total_loss: float = float("nan")
    converged: bool = False
    logger: Optional[object] = None      # training_logger passed to fit()
    chain_topology: bool = True          # layer i feeds exactly layer i+1

    def __getitem__(self, name):
        return self.layers[name]

    def predict(self, newdata):
        """Project new samples through the fitted layers
        (R/factor_methods.R:742-777 predict.factor_net_result).

        Single layer: returns H_new (k, n_new).  Multi-layer: chains —
        each layer's H_new (transposed) feeds the next — and returns
        {layer_name: H_new}.  Multi-modal first layers need the
        modalities row-concatenated in training order.  Branched DAGs
        (Add/Concat/multi-input) have no single forward path for new
        samples, so projecting through them is refused rather than
        silently chaining embeddings through the wrong layers.
        """
        from .project import nnls
        items = list(self.layers.items())
        if len(items) > 1 and not self.chain_topology:
            raise ValueError(
                "predict() supports linear-chain graphs only (each layer "
                "feeding the next); this net has Add/Concat/branched "
                "inputs — project through the individual layers manually")

        def _project(lr, X):
            W = np.asarray(lr.W) * np.asarray(lr.d)[None, :]
            return nnls(X, w=W)

        if len(items) == 1:
            return _project(items[0][1], newdata)
        current = np.asarray(newdata, dtype=np.float32)
        out = {}
        for i, (name, lr) in enumerate(items):
            if i == 0:
                emb = np.asarray(_project(lr, current))   # (k1, n_new)
            else:
                # deeper layers factorize t(H_prev): new samples are new
                # ROWS there, so the projection basis is (d * H).T
                basis = np.asarray(lr.H).T * np.asarray(lr.d)[None, :]
                emb = np.asarray(nnls(current, w=basis))  # (k_l, n_new)
            out[name] = emb
            current = emb
        return out


class FactorNet:
    """Compiled factorization graph (graph/graph.hpp:115)."""

    def __init__(self, inputs: Sequence[Input], output: Node, *,
                 config: Optional[GlobalConfig] = None,
                 maxit: Optional[int] = None, tol: Optional[float] = None,
                 seed: Optional[int] = None, verbose: Optional[bool] = None):
        self.inputs = list(inputs)
        self.output = output
        cfg = config or GlobalConfig()
        # direct kwargs override the global config (back-compat surface)
        self.config = cfg
        self.maxit = cfg.maxit if maxit is None else int(maxit)
        self.tol = cfg.tol if tol is None else float(tol)
        self.seed = (cfg.seed if seed is None else seed) or 0
        self.verbose = cfg.verbose if verbose is None else bool(verbose)
        self._layers: List[Node] = []
        self._compiled = False
        self._fused_fn = None

    # -- topology ----------------------------------------------------------
    def compile(self) -> "FactorNet":
        """Topological collection + validation of layer nodes.

        DFS with an in-progress set so a cycle (only constructible by
        mutating node inputs after the functional builders) raises instead
        of silently fitting layers against stale upstream states."""
        done = set()
        in_progress = set()
        order: List[Node] = []

        def visit(node: Node):
            if id(node) in done:
                return
            if id(node) in in_progress:
                raise ValueError("graph contains a cycle")
            in_progress.add(id(node))
            if isinstance(node, (NMFLayer, SVDLayer)):
                visit(node.input)
                order.append(node)
            elif isinstance(node, Condition):
                visit(node.input)
            elif isinstance(node, (Concat, Add, Shared)):
                for branch in node.inputs:
                    visit(branch)
            elif isinstance(node, Input):
                pass
            else:
                raise TypeError(f"unknown node type {type(node)}")
            in_progress.discard(id(node))
            done.add(id(node))

        visit(self.output)
        if not order:
            raise ValueError("graph contains no factorization layers")
        names = [l.name for l in order]
        if len(set(names)) != len(names):
            raise ValueError("layer names must be unique")
        self._layers = order
        self._compiled = True
        return self

    @property
    def n_layers(self) -> int:
        return len(self._layers)

    # -- data resolution ---------------------------------------------------

    def _resolve_source(self, node: Node):
        """Walk conditions to the data-bearing node; return (source, Z_list)."""
        zs = []
        while isinstance(node, Condition):
            zs.append(node.Z)
            node = node.input
        return node, zs

    def _io_dims(self, data_shapes, z_cols=None):
        """Per-layer (a_i, b_i) input-matrix dims implied by the given
        data-node shapes (node id -> (rows, cols)) — used by the mesh path
        to compute pad-strip extents without materializing anything.
        Layer i factorizes X_i (a_i, b_i): W_i is (a_i, k_i), H_i is
        (k_i, b_i).

        Returns (dims, z_cols).  Covariate orientation (is Z (a, q) or
        (q, a)?) is only decidable against TRUE dims — when called with
        PADDED shapes, pass the ``z_cols`` list from the true-dims call so
        the covariate column counts are not re-inferred against padded a
        (they would resolve to the sample count)."""
        dims = []
        out_z = []
        idx_of = {id(l): j for j, l in enumerate(self._layers)}
        for layer in self._layers:
            node, zs = self._resolve_source(layer.input)
            if isinstance(node, (Input, Shared)):
                a, b = data_shapes[id(node)]
            elif isinstance(node, Concat):
                branches = [self._resolve_source(br)[0]
                            for br in node.inputs]
                if any(id(br) not in idx_of for br in branches):
                    raise ValueError("concat branch is not a layer")
                a = dims[idx_of[id(branches[0])]][1]
                b = sum(self._layers[idx_of[id(br)]].k for br in branches)
            elif isinstance(node, Add):
                b0 = self._resolve_source(node.inputs[0])[0]
                if id(b0) not in idx_of:
                    raise ValueError("add branch is not a layer")
                j = idx_of[id(b0)]
                a, b = dims[j][1], self._layers[j].k
            else:                                   # chained layer
                j = idx_of[id(node)]
                a, b = dims[j][1], self._layers[j].k
            if z_cols is not None:
                zc = z_cols[len(dims)]
            else:
                zc = sum((Z.shape[1] if Z.shape[0] == a else Z.shape[0])
                         for Z in zs)
            out_z.append(int(zc))
            b += zc
            dims.append((int(a), int(b)))
        return dims, out_z

    def _is_chain(self) -> bool:
        """True iff every layer i > 0 consumes exactly layer i-1's output
        (the only topology GraphResult.predict can forward new samples
        through)."""
        for i, layer in enumerate(self._layers):
            node, zs = self._resolve_source(layer.input)
            if i == 0:
                if not isinstance(node, (Input, Shared)):
                    return False
            else:
                if zs or node is not self._layers[i - 1]:
                    return False
        return True

    def _input_matrix(self, node: Node):
        """Materialize the dense data for an INPUT / SHARED source node.

        Returns (matrix, row_blocks) where row_blocks maps input names to
        row slices for shared multi-modal splits."""
        if isinstance(node, Input):
            d = node.data
            if hasattr(d, "todense"):
                d = np.asarray(d.todense())
            return np.asarray(d, dtype=np.float32), None
        if isinstance(node, Shared):
            mats = []
            blocks = {}
            row = 0
            ncols = None
            for inp in node.inputs:
                d = inp.data
                if hasattr(d, "todense"):
                    d = np.asarray(d.todense())
                d = np.asarray(d, dtype=np.float32)
                if ncols is None:
                    ncols = d.shape[1]
                elif d.shape[1] != ncols:
                    raise ValueError("shared inputs must have equal columns")
                blocks[inp.name] = slice(row, row + d.shape[0])
                row += d.shape[0]
                mats.append(d)
            return np.vstack(mats), blocks
        raise TypeError(f"cannot materialize data from {type(node)}")

    # -- per-layer kwargs / config ----------------------------------------

    def _layer_kwargs(self, layer: Node):
        """Merged nmf() kwargs for one layer: global dots (lowest priority)
        < global named settings < layer kwargs / W-H side configs
        (graph/graph.hpp:246-286 build_layer_config).

        Returns (kw, arrays) with graph/target matrices split out into the
        ``arrays`` dict keyed graph_W/graph_H/target_W/target_H."""
        gc = self.config
        kw = dict(gc.dots)
        kw.update(layer.fit_kwargs)
        arrays = {}
        if isinstance(layer, SVDLayer):
            # SVD layers run the same outer-ALS machinery without the
            # nonnegativity constraint (graph/fit.hpp handles both layer
            # kinds through the NMF engine)
            kw.setdefault("nonneg", (False, False))
        if isinstance(layer, NMFLayer):
            for side, fc in (("W", layer.W), ("H", layer.H)):
                for key, val in fc.items():
                    if key in ("graph", "target"):
                        arrays[f"{key}_{side}"] = val
                        continue
                    arr = kw.get(key, [0.0, 0.0] if key != "nonneg"
                                 else [True, True])
                    # always copy before writing: kw values may alias the
                    # SHARED lists inside gc.dots / layer.fit_kwargs, and
                    # an in-place write would leak this layer's side
                    # config into every other layer and later fit
                    arr = [arr, arr] if np.isscalar(arr) else list(arr)
                    arr[0 if side == "W" else 1] = val
                    kw[key] = arr
            kw.setdefault("loss", layer.loss if layer.loss != "mse"
                          else gc.loss)
        kw.setdefault("solver", gc.solver)
        kw.setdefault("norm", gc.norm)
        # graph-level CV settings propagate to every layer (graph.hpp:263-267)
        kw.setdefault("test_fraction", gc.test_fraction)
        kw.setdefault("cv_seed", gc.cv_seed)
        kw.setdefault("mask_zeros", gc.mask_zeros)
        kw.setdefault("cv_patience", gc.patience)
        return kw, arrays

    # -- fitting -----------------------------------------------------------

    def _fit_layer(self, layer: Node, data, *, maxit, w_init=None,
                   tol=None, seed=None, sort_model=False) -> NMFResult:
        from ..api import nmf as nmf_api
        kw, arrays = self._layer_kwargs(layer)
        kw["maxit"] = maxit
        if tol is not None:
            kw["tol"] = tol
        kw.setdefault("seed", self.seed if seed is None else seed)
        kw["sort_model"] = sort_model
        return nmf_api(data, layer.k, w_init=w_init, **arrays, **kw)

    def _effective_input(self, i: int, states: List[LayerResult],
                         data_map, xp=np):
        """graph/fit.hpp:95-185.  ``xp``: numpy for the host path, jnp for
        the traced/fused path (states then hold (W_T, H, d) device tuples
        accessed via ``.H``-compatible indexing below)."""
        layer = self._layers[i]
        node, zs = self._resolve_source(layer.input)
        idx_of = {id(l): j for j, l in enumerate(self._layers)}

        def h_of(j):
            s = states[j]
            return s.H if hasattr(s, "H") else s[1]

        if isinstance(node, (Input, Shared)):
            result = data_map[id(node)][0]
        elif isinstance(node, Concat):
            parts = []
            for branch in node.inputs:
                b, _ = self._resolve_source(branch)
                j = idx_of.get(id(b))
                if j is None:
                    raise ValueError("concat branch is not a layer")
                parts.append(h_of(j).T)
            ns = {int(p.shape[0]) for p in parts}
            if len(ns) > 1:
                raise ValueError(
                    f"factor_concat branches have mismatched sample "
                    f"counts {sorted(ns)} (all branch H factors must "
                    f"cover the same columns)")
            result = xp.concatenate(parts, axis=1)
        elif isinstance(node, Add):
            total = None
            for branch in node.inputs:
                b, _ = self._resolve_source(branch)
                j = idx_of.get(id(b))
                if j is None:
                    raise ValueError("add branch is not a layer")
                h = h_of(j)
                if total is not None and h.shape != total.shape:
                    raise ValueError(
                        f"factor_add branches have mismatched H shapes "
                        f"{total.shape} vs {h.shape} (equal rank k and "
                        f"equal sample count required)")
                total = h if total is None else total + h
            result = total.T
        elif isinstance(node, (NMFLayer, SVDLayer)):
            result = h_of(idx_of[id(node)]).T                # n x k_prev
        else:
            raise TypeError(f"bad input node {type(node)}")

        for Z in reversed(zs):
            n = result.shape[0]
            Zo = Z if Z.shape[0] == n else Z.T
            if Zo.shape[0] != n:
                raise ValueError("conditioning Z dimension mismatch")
            result = xp.concatenate([result, Zo.astype(np.float32)], axis=1)
        return result

    # -- fused on-device deep fit -----------------------------------------

    def _deep_cfgs(self):
        """Per-layer (NMFConfig, aux arrays) for the fused path; None if a
        layer needs machinery the fused sweep doesn't cover (IRLS / CV /
        projective / symmetric / robust)."""
        from ..api import build_config
        from ..config import Loss
        out = []
        for layer in self._layers:
            kw, arrays = self._layer_kwargs(layer)
            for drop in ("maxit", "verbose", "seed", "sort_model"):
                kw.pop(drop, None)
            try:
                cfg = build_config(layer.k, maxit=1, sort_model=False,
                                   seed=self.seed,
                                   has_graph_W="graph_W" in arrays,
                                   has_graph_H="graph_H" in arrays,
                                   has_target_W="target_W" in arrays,
                                   has_target_H="target_H" in arrays,
                                   **kw)
            except (TypeError, ValueError):
                return None
            if (cfg.loss != Loss.MSE or cfg.requires_irls() or cfg.is_cv()
                    or cfg.projective or cfg.symmetric):
                return None
            aux = {}
            for key, mat in arrays.items():
                t = np.asarray(mat, dtype=np.float32)
                aux[key] = t
                fc = cfg.W if key.endswith("_W") else cfg.H
                if key.startswith("target") and fc.target_lambda < 0:
                    aux[key + "_gram"] = (t @ t.T) / t.shape[1]
            out.append((cfg, aux))
        return out

    def _build_fused(self, cfgs_auxs, data_ids, sizes=None):
        """One jitted executable running the whole outer ALS on device.

        All arrays (data panels, covariates, aux matrices, initial states)
        are jit ARGUMENTS — nothing is closure-captured, so the compiler
        never embeds them as constants."""
        import jax
        import jax.numpy as jnp
        from jax import lax
        from ..ops import linalg
        from .nmf import make_updates

        layers = self._layers
        tol = self.tol
        maxit = self.maxit
        cfgs = [c for c, _ in cfgs_auxs]
        z_lists = [self._resolve_source(l.input)[1] for l in layers]

        def eff(i, states, datas, zs):
            data_map = {nid: (datas[pos], None)
                        for nid, pos in data_ids.items()}
            # swap per-layer Zs in for the traced ones
            layer = layers[i]
            node, _ = self._resolve_source(layer.input)
            idx_of = {id(l): j for j, l in enumerate(layers)}
            if isinstance(node, (Input, Shared)):
                result = data_map[id(node)][0]
            elif isinstance(node, Concat):
                parts = []
                for branch in node.inputs:
                    b, _ = self._resolve_source(branch)
                    parts.append(states[idx_of[id(b)]][1].T)
                result = jnp.concatenate(parts, axis=1)
            elif isinstance(node, Add):
                total = None
                for branch in node.inputs:
                    b, _ = self._resolve_source(branch)
                    h = states[idx_of[id(b)]][1]
                    total = h if total is None else total + h
                result = total.T
            else:
                result = states[idx_of[id(node)]][1].T
            for Z in reversed(zs[i]):
                n = result.shape[0]
                Zo = Z if Z.shape[0] == n else Z.T
                result = jnp.concatenate([result, Zo], axis=1)
            return result

        n_layers = len(layers)

        @jax.jit
        def run(datas, zs, auxs, states0):
            def body(carry):
                states, it, prev_loss, _, _, hist = carry
                states = list(states)
                total = jnp.float32(0.0)
                layer_losses = []
                frobs = []
                for i in range(len(layers)):
                    h_upd, w_upd, _ = make_updates(cfgs[i], auxs[i])
                    B = eff(i, states, datas, zs)
                    W_T, Hm, d = states[i]
                    Hm, d = h_upd(B, W_T, Hm, d, it + 1)
                    W_T, Hm, d, B_w, G_w = w_upd(B, W_T, Hm, d, it + 1)
                    states[i] = (W_T, Hm, d)
                    # per-layer mean-squared loss via the saved-matrix Gram
                    # trick (fit.hpp:334-344 computes the dense recon; this
                    # avoids the (m, n) intermediate entirely)
                    trB = jnp.sum(B * B)
                    sse = linalg.mse_loss_from_saved(trB, W_T, d, B_w, G_w)
                    # normalize by the TRUE element count: on the mesh path
                    # B carries zero pads whose SSE contribution is zero but
                    # whose element count is not (the pads would understate
                    # every loss and skew the rel-tol convergence test)
                    n_elem = (sizes[i] if sizes is not None
                              else B.shape[0] * B.shape[1])
                    lyr = sse / n_elem
                    total = total + lyr
                    layer_losses.append(lyr)
                    # recon Frobenius norm via the k x k Gram trick:
                    # ||W diag(d) H||_F^2 = tr(diag(d) W'W diag(d) HH')
                    Wd = W_T * d[:, None]
                    GW = jnp.dot(Wd, Wd.T, precision=linalg.PREC)
                    HHt = jnp.dot(Hm, Hm.T, precision=linalg.PREC)
                    frobs.append(jnp.sqrt(jnp.maximum(
                        jnp.sum(GW * HHt), 0.0)))
                rel = jnp.abs(prev_loss - total) / (jnp.abs(prev_loss) + 1e-15)
                conv = jnp.isfinite(prev_loss) & (rel < tol)
                # training_logger history (R/training_log.R records total
                # loss + per-layer Frobenius norms each outer iteration)
                hist = hist.at[it, 0].set(total)
                hist = hist.at[it, 1:1 + n_layers].set(
                    jnp.stack(layer_losses))
                hist = hist.at[it, 1 + n_layers:].set(jnp.stack(frobs))
                return (tuple(states), it + 1, total, total, conv, hist)

            def cond(carry):
                _, it, _, _, conv, _ = carry
                return (it < maxit) & jnp.logical_not(conv)

            hist0 = jnp.full((maxit, 1 + 2 * n_layers), jnp.nan,
                             dtype=jnp.float32)
            init = (states0, jnp.int32(0), jnp.float32(jnp.inf),
                    jnp.float32(jnp.nan), jnp.bool_(False), hist0)
            return lax.while_loop(cond, body, init)

        return run

    def _fit_deep_fused(self, data_map, logger=None,
                        mesh=None) -> Optional[GraphResult]:
        """Fully on-device outer ALS.  Returns None when ineligible (then
        the host-driven loop below runs, exactly like the reference).

        ``mesh``: optional jax.sharding.Mesh — each modality's data is
        block-sharded over (rows, cols), factor states replicated, and the
        SAME fused executable runs under GSPMD (Gram all-reduces inserted
        from the data shardings; uneven dims use jax's native uneven
        sharding, no padding needed since the program is semantics-
        preserving under GSPMD)."""
        cfgs_auxs = self._deep_cfgs()
        if cfgs_auxs is None:
            if mesh is not None:
                raise ValueError(
                    "mesh= requires the fused graph path; this graph has "
                    "a layer configuration (IRLS loss / CV holdout / "
                    "streaming input) that runs on the host loop")
            return None
        import jax
        import jax.numpy as jnp

        shard = repl = None
        strip_dims = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec
            from ..parallel.mesh import check_pad_soundness, mesh_padding
            shard = NamedSharding(mesh, PartitionSpec("rows", "cols"))
            repl = NamedSharding(mesh, PartitionSpec())

        # warmup fits per layer (fit.hpp:280-300), device-resident inputs
        init_maxit = min(10, self.maxit)
        seed_base = self.seed if self.seed else 42
        data_ids = {}
        datas_raw = []          # unpadded, for the warmup fits
        datas = []              # padded + sharded, for the fused executable
        true_shapes = {}
        pad_shapes = {}
        for layer in self._layers:
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, (Input, Shared)) and id(node) not in data_ids:
                data_ids[id(node)] = len(datas)
                # cache the device copy per data node: re-fitting the same
                # net must not re-upload the matrix (on a remote link the
                # upload dwarfs the fit — 145 MB ~ 2.4 s vs a 0.1 s fit).
                # Cache entries carry a strided-sample fingerprint so
                # replacing (or mutating) a node's data invalidates them
                # instead of silently fitting the old matrix.
                if not hasattr(self, "_dev_cache"):
                    self._dev_cache = {}
                host = data_map[id(node)][0]
                flat = np.ravel(host)
                step = max(1, flat.size // 1024)
                fp = (host.shape, str(host.dtype),
                      flat[::step].tobytes())
                cached = self._dev_cache.get(id(node))
                if cached is not None and cached[0] == fp:
                    d = cached[1]
                else:
                    d = jnp.asarray(host)
                    self._dev_cache[id(node)] = (fp, d)
                true_shapes[id(node)] = d.shape
                datas_raw.append(d)
                if shard is not None:
                    # zero-pad to mesh-divisible dims (exact for the
                    # fused-eligible MSE layers: zero rows/cols solve to
                    # exactly zero — parallel/mesh.py pad_to_mesh), then
                    # block-shard; pads are stripped at packaging below
                    pm, pn = mesh_padding(mesh, *d.shape)
                    for cfg_i, _ in cfgs_auxs:
                        check_pad_soundness(cfg_i, pm, pn)
                    if pm or pn:
                        d = jnp.pad(d, ((0, pm), (0, pn)))
                    d = jax.device_put(d, shard)
                pad_shapes[id(node)] = d.shape
                datas.append(d)
        datas = tuple(datas)
        dev_map = {nid: (datas_raw[pos], None)
                   for nid, pos in data_ids.items()}

        dims_t, z_cols_t = self._io_dims(true_shapes)
        z_pad = None
        if shard is not None:
            dims_p, _ = self._io_dims(pad_shapes, z_cols=z_cols_t)
            if pad_shapes != true_shapes:
                strip_dims = dims_t
            z_pad = [dims_p[i][0] - dims_t[i][0]
                     for i in range(self.n_layers)]

        # warmups run on UNPADDED data/states so mesh and single-device
        # fits share the same random init and warm trajectory bit-for-bit
        states_raw: List[tuple] = [None] * self.n_layers  # type: ignore
        for i, layer in enumerate(self._layers):
            inp = self._effective_input(i, states_raw, dev_map, xp=jnp)
            res = self._fit_layer(layer, inp, maxit=init_maxit,
                                  seed=seed_base + i)
            states_raw[i] = (jnp.asarray(np.ascontiguousarray(res.W.T)),
                             jnp.asarray(res.H), jnp.asarray(res.d))
        states = list(states_raw)
        if shard is not None:
            for i, st in enumerate(states_raw):
                pa = dims_p[i][0] - dims_t[i][0]
                pb = dims_p[i][1] - dims_t[i][1]
                st = (jnp.pad(st[0], ((0, 0), (0, pa))),
                      jnp.pad(st[1], ((0, 0), (0, pb))), st[2])
                states[i] = tuple(jax.device_put(x, repl) for x in st)

        def _prep_z(i, Z):
            Z = jnp.asarray(Z, jnp.float32)
            if z_pad and z_pad[i]:
                # condition covariates must cover the padded samples too;
                # zero rows keep the pad solves exactly zero.  The sample
                # axis is whichever dim matches the TRUE layer row count
                # (eff() accepts both (a, q) and (q, a) orientations)
                if Z.shape[0] == dims_t[i][0]:
                    Z = jnp.pad(Z, ((0, z_pad[i]), (0, 0)))
                else:
                    Z = jnp.pad(Z, ((0, 0), (0, z_pad[i])))
            return jax.device_put(Z, repl) if repl is not None else Z

        zs = tuple(tuple(_prep_z(i, Z) for Z in
                         self._resolve_source(l.input)[1])
                   for i, l in enumerate(self._layers))
        auxs = tuple({k: (jax.device_put(jnp.asarray(v), repl)
                          if repl is not None else jnp.asarray(v))
                      for k, v in aux.items()}
                     for _, aux in cfgs_auxs)

        if self._fused_fn is None:
            self._fused_fn = self._build_fused(
                cfgs_auxs, data_ids,
                sizes=tuple(a * b for a, b in dims_t))
        out_states, it, loss, _, conv, hist = jax.device_get(
            self._fused_fn(datas, zs, auxs, tuple(states)))

        out = GraphResult(total_iterations=int(it), total_loss=float(loss),
                          converged=bool(conv),
                          chain_topology=self._is_chain())
        if logger is not None:
            names = [l.name for l in self._layers]
            for t in range(int(it)):
                logger.records.append({
                    "iter": t + 1,
                    "train_loss": float(hist[t, 0]),
                    **{f"{nm}_loss": float(hist[t, 1 + j])
                       for j, nm in enumerate(names)},
                    **{f"{nm}_frobenius":
                       float(hist[t, 1 + len(names) + j])
                       for j, nm in enumerate(names)},
                })
            out.logger = logger
        for i, layer in enumerate(self._layers):
            W_T, Hm, d = out_states[i]
            W = np.asarray(W_T).T
            Hm = np.asarray(Hm)
            if strip_dims is not None:
                a_i, b_i = strip_dims[i]
                W = W[:a_i]                  # mesh pads solve to exact zero
                Hm = Hm[:, :b_i]
            # per-layer loss from the history row of the last completed
            # iteration (hist[:, 1+i]); the total is on the GraphResult
            layer_loss = (float(hist[int(it) - 1, 1 + i]) if int(it) > 0
                          else float("nan"))
            s = LayerResult(W=W, d=np.asarray(d),
                            H=Hm, iterations=int(it),
                            loss=layer_loss, converged=bool(conv))
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, Shared):
                _, blocks = data_map[id(node)]
                s.W_blocks = {name: s.W[sl] for name, sl in blocks.items()}
            out.layers[layer.name] = s
        return out

    def fit(self, logger=None, mesh=None) -> GraphResult:
        if not self._compiled:
            self.compile()
        if mesh is not None and self.n_layers == 1:
            raise ValueError("mesh= on a single-layer graph: call "
                             "nmf(..., mesh=) / fit_sharded directly")

        # materialize data-bearing nodes once
        data_map = {}
        for layer in self._layers:
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, (Input, Shared)) and id(node) not in data_map:
                data_map[id(node)] = self._input_matrix(node)

        if self.n_layers == 1:
            layer = self._layers[0]
            node, zs = self._resolve_source(layer.input)
            data, blocks = data_map[id(node)]
            # Condition covariates (zs) are appended by _effective_input —
            # the raw matrix would silently drop them (graph/fit.hpp:95-185
            # applies conditioning on the single-layer path too)
            if zs or not isinstance(node, (Input, Shared)):
                data = self._effective_input(0, [], data_map)
            res = self._fit_layer(layer, data, maxit=self.maxit, tol=self.tol,
                                  sort_model=True)
            lr = LayerResult(W=res.W, d=res.d, H=res.H,
                             iterations=res.iterations, loss=res.train_loss,
                             test_loss=res.test_loss,
                             best_test_loss=res.misc.get(
                                 "best_test_loss", float("nan")),
                             converged=res.converged)
            if blocks:
                lr.W_blocks = {name: res.W[sl] for name, sl in blocks.items()}
            out = GraphResult(layers={layer.name: lr},
                              total_iterations=res.iterations,
                              total_loss=res.train_loss,
                              converged=res.converged)
            if logger is not None:
                logger.attach_history(res)
                out.logger = logger
            return out

        # ---- multi-layer outer ALS ----
        fused = self._fit_deep_fused(data_map, logger=logger, mesh=mesh)
        if fused is not None:
            if self.verbose:
                print(f"  fused outer ALS: {fused.total_iterations} iters, "
                      f"loss = {fused.total_loss:.6g}")
            return fused

        # host-driven fallback (graph/fit.hpp:265-355): IRLS losses, CV
        # holdouts, streaming inputs
        n_layers = self.n_layers
        states: List[LayerResult] = [None] * n_layers       # type: ignore
        init_maxit = min(10, self.maxit)
        seed_base = self.seed if self.seed else 42

        for i, layer in enumerate(self._layers):
            inp = self._effective_input(i, states, data_map)
            res = self._fit_layer(layer, inp, maxit=init_maxit,
                                  seed=seed_base + i)
            states[i] = LayerResult(W=res.W, d=res.d, H=res.H,
                                    test_loss=res.test_loss)

        prev_loss = np.inf
        total_iter = 0
        converged = False
        for _outer in range(self.maxit):
            for i, layer in enumerate(self._layers):
                inp = self._effective_input(i, states, data_map)
                res = self._fit_layer(layer, inp, maxit=1, tol=0.0,
                                      w_init=states[i].W,
                                      seed=seed_base + i)
                states[i] = LayerResult(W=res.W, d=res.d, H=res.H,
                                        test_loss=res.test_loss)
            total_iter += 1

            cur_loss = 0.0
            entry = {"iter": total_iter}
            for i, layer in enumerate(self._layers):
                inp = self._effective_input(i, states, data_map)
                s = states[i]
                recon = (s.W * s.d[None, :]) @ s.H
                lyr = float(np.mean((inp - recon) ** 2))
                cur_loss += lyr
                entry[f"{layer.name}_loss"] = lyr
                entry[f"{layer.name}_frobenius"] = float(
                    np.linalg.norm(recon))
            if logger is not None:
                logger.records.append(
                    {"iter": total_iter, "train_loss": cur_loss,
                     **{k: v for k, v in entry.items() if k != "iter"}})
            if self.verbose:
                print(f"  outer iter {total_iter}: loss = {cur_loss:.6g}")
            if np.isfinite(prev_loss):
                rel = abs(prev_loss - cur_loss) / (abs(prev_loss) + 1e-15)
                if rel < self.tol:
                    converged = True
                    prev_loss = cur_loss
                    break
            prev_loss = cur_loss

        out = GraphResult(total_iterations=total_iter,
                          total_loss=float(prev_loss), converged=converged,
                          logger=logger, chain_topology=self._is_chain())
        for i, layer in enumerate(self._layers):
            s = states[i]
            s.iterations = total_iter
            s.loss = float(prev_loss)
            s.converged = converged
            node, _ = self._resolve_source(layer.input)
            if isinstance(node, Shared):
                _, blocks = data_map[id(node)]
                s.W_blocks = {name: s.W[sl] for name, sl in blocks.items()}
            out.layers[layer.name] = s
        return out


def factor_net(inputs, output, *, config: Optional[GlobalConfig] = None,
               maxit: Optional[int] = None, tol: Optional[float] = None,
               seed: Optional[int] = None,
               verbose: Optional[bool] = None) -> FactorNet:
    """Build (and compile) a FactorNet (R/factor_net.R factor_net())."""
    if isinstance(inputs, Input):
        inputs = [inputs]
    return FactorNet(inputs, output, config=config, maxit=maxit, tol=tol,
                     seed=seed, verbose=verbose).compile()


def fit(net: FactorNet, *, logger=None, mesh=None) -> GraphResult:
    """Fit a compiled FactorNet.  ``logger`` is a ``training_logger()``
    that records one entry per outer iteration: total loss, per-layer
    loss, and per-layer reconstruction Frobenius norm
    (R/factor_methods.R fit.factor_net logger wiring).  ``mesh``: run the
    fused outer ALS under GSPMD over a (rows, cols) device mesh."""
    return net.fit(logger=logger, mesh=mesh)


# ---------------------------------------------------------------------------
# Cross-validation grid / random search (R/cross_validate_graph.R:86-231)
# ---------------------------------------------------------------------------

@dataclass
class GraphCVResult:
    """``factor_net_cv``: per-fit rows, per-combo summary, winning params."""
    results: List[dict]
    summary: List[dict]
    best_params: dict
    config: GlobalConfig
    params: dict
    strategy: str
    reps: int
    all_fits: Optional[list] = None

    def __repr__(self):
        lines = ["factor_net cross-validation",
                 f"  Strategy: {self.strategy} | Reps: {self.reps} | "
                 f"Combos: {len(self.summary)}",
                 f"  Holdout: {self.config.test_fraction * 100:.1f}%",
                 f"  Best: " + ", ".join(f"{k} = {v}"
                                         for k, v in self.best_params.items())]
        return "\n".join(lines)


def cross_validate_graph(inputs, layer_fn, params: dict, *,
                         config: Optional[GlobalConfig] = None,
                         reps: int = 3, strategy: str = "grid",
                         n_random: int = 20, seed: int = 42,
                         verbose: bool = False,
                         keep_fits: bool = False) -> GraphCVResult:
    """Hyperparameter grid/random search with speckled-holdout CV
    (R/cross_validate_graph.R:86).

    ``layer_fn(p)`` receives one named parameter combination (a dict) and
    returns the output layer node; each combination is fitted ``reps``
    times with per-rep CV seeds ``seed + ci*reps + ri`` and ranked by mean
    held-out test loss.

    Example::

        inp = factor_input(X)
        cv = cross_validate_graph(
            inp, lambda p: nmf_layer(inp, p["k"], W=W(L1=p["L1"])),
            params={"k": [3, 5, 10], "L1": [0.0, 0.01]},
            config=factor_config(maxit=50, seed=42))
        cv.best_params
    """
    if strategy not in ("grid", "random"):
        raise ValueError("strategy must be 'grid' or 'random'")
    if not callable(layer_fn):
        raise ValueError("'layer_fn' must be a function(p) returning the "
                         "output layer node")
    if not isinstance(params, dict) or not params:
        raise ValueError("'params' must be a non-empty dict of parameter "
                         "value lists")

    cfg = config or factor_config()
    if cfg.test_fraction == 0:
        cfg = cfg.replace(test_fraction=0.1)
    if isinstance(inputs, Input):
        inputs = [inputs]

    names = list(params)
    grid = [dict(zip(names, combo))
            for combo in itertools.product(*(params[n] for n in names))]
    if strategy == "random" and len(grid) > n_random:
        rs = np.random.RandomState(seed)
        pick = rs.choice(len(grid), size=n_random, replace=False)
        grid = [grid[i] for i in sorted(pick)]

    if verbose:
        print(f"Cross-validating {len(grid)} parameter combinations x "
              f"{reps} reps = {len(grid) * reps} fits")

    results: List[dict] = []
    fits = [] if keep_fits else None
    for ci, p in enumerate(grid):
        if verbose:
            print(f"  [{ci + 1}/{len(grid)}] "
                  + ", ".join(f"{k} = {v}" for k, v in p.items()))
        for ri in range(1, reps + 1):
            rep_cv_seed = int(seed + ci * reps + ri)
            cv_cfg = cfg.replace(cv_seed=rep_cv_seed)
            row = dict(p)
            row.update(combo=ci, rep=ri, test_loss=float("nan"),
                       train_loss=float("nan"), iterations=0,
                       converged=False)
            try:
                output = layer_fn(dict(p))
                net = factor_net(inputs, output, config=cv_cfg)
                res = net.fit()
            except Exception as e:                       # noqa: BLE001
                warnings.warn(f"fit failed for combo {ci + 1}, rep {ri}: {e}")
                results.append(row)
                if fits is not None:
                    fits.append(None)
                continue
            first = res.layers[net._layers[0].name]
            row.update(test_loss=float(first.test_loss),
                       train_loss=float(first.loss),
                       iterations=int(first.iterations),
                       converged=bool(first.converged))
            results.append(row)
            if fits is not None:
                fits.append(res)

    summary = []
    for ci, p in enumerate(grid):
        tl = [r["test_loss"] for r in results
              if r["combo"] == ci and np.isfinite(r["test_loss"])]
        trl = [r["train_loss"] for r in results
               if r["combo"] == ci and np.isfinite(r["train_loss"])]
        summary.append(dict(
            p, combo=ci,
            mean_test_loss=float(np.mean(tl)) if tl else float("nan"),
            se_test_loss=(float(np.std(tl, ddof=1) / np.sqrt(len(tl)))
                          if len(tl) > 1 else float("nan")),
            mean_train_loss=float(np.mean(trl)) if trl else float("nan"),
            n_valid=len(tl)))
    summary.sort(key=lambda s: (np.isnan(s["mean_test_loss"]),
                                s["mean_test_loss"]))
    best = summary[0] if summary else {}
    best_params = {k: best[k] for k in names} if best else {}

    if verbose and best:
        print(f"\nBest: " + ", ".join(f"{k} = {v}"
                                      for k, v in best_params.items())
              + f" -> test_loss = {best['mean_test_loss']:.6f}")

    return GraphCVResult(results=results, summary=summary,
                         best_params=best_params, config=cfg, params=params,
                         strategy=strategy, reps=reps, all_fits=fits)
