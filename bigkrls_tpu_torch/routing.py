"""Pure fit-route selection, copied from ``bigkrls_tpu/routing.py``.

The port runs the adaptive, fused and stepwise routes; ``model.fit``
raises for the streaming route and for a mesh or checkpoint directory.

The eigendecomposition-route decision — which of the four execution
strategies a fit takes through steps 2–4 — used to live as interleaved
conditionals spread over ~170 lines of ``model._fit_impl``, mixing six
booleans (streaming × mesh × checkpoint × explicit-λ/L/U × eig_method ×
size).  It is extracted here as ONE pure function over the fit
configuration, so the full boolean lattice is unit-testable without
running a fit (``tests/test_routing.py`` sweeps it exhaustively) and
``model.py`` consumes a single decision instead of re-deriving
eligibility per branch.

The four routes (reference mapping: the reference has exactly one —
full dense eigh, ``R/bigKRLS_Rcpp_functions.R:171-199`` — the other
three are the TPU-first designs layered on the same semantics):

* ``streaming`` — kernel-free subspace iteration; K is never
  materialized (``ops/matvec.py`` + ``ops/eig.eigensystem_streaming``).
* ``adaptive``  — block-Krylov head + moment-completed λ bounds in one
  fused dispatch (``ops/adaptive.py``); the default at N ≥ 2048 with a
  real truncation.  May DECLINE at runtime (flat spectrum) — the caller
  then re-selects with ``adaptive_declined=True``.
* ``fused``     — dense eigh + λ search + solve as one device program
  (``ops/fused.py``); the single-chip dense default.
* ``stepwise``  — separate kernel/eig/λ/solve dispatches
  (``ops/eig.eigensystem``): the mesh path (replicated-eigh vs
  block-Jacobi by measured memory crossover), the bit-exact-resume
  checkpoint path, explicit λ/L/U fits, truncated ``neig < N`` fits,
  and explicit non-auto eig methods.
"""
from __future__ import annotations

import dataclasses

ROUTES = ("streaming", "adaptive", "fused", "stepwise")

# the adaptive route's auto-on size floor: below this a dense eigh is
# measured faster than Krylov + moments + verification (see
# ops/adaptive.postkernel_adaptive's kcap guard, which additionally
# declines when N/4 < 64 at runtime)
ADAPTIVE_AUTO_MIN_N = 2048


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    route: str    # one of ROUTES
    reason: str   # human-readable: why this route is the one


def select_route(
    *,
    n: int,
    neig: int,
    eigtrunc: float,
    eig_method: str = "auto",
    streaming: bool = False,
    mesh_present: bool = False,
    checkpoint_present: bool = False,
    explicit_lambda: bool = False,
    explicit_L: bool = False,
    explicit_U: bool = False,
    adaptive_declined: bool = False,
) -> RouteDecision:
    """Select the steps-2–4 execution route for one fit configuration.

    Pure: no device access, no I/O — every input is a plain value the
    orchestrator already holds after validation.  ``adaptive_declined``
    is the one runtime feedback edge: when the adaptive route returns
    ``None`` (spectrum too flat to capture within N/4 eigenpairs), the
    orchestrator re-invokes with ``adaptive_declined=True`` to obtain
    the documented fallback (dense, with ``eig_method='adaptive'``
    treated as 'auto')."""
    if streaming:
        return RouteDecision(
            "streaming",
            "streaming fit: kernel-free subspace iteration, K never "
            "materialized")

    explicit = explicit_lambda or explicit_L or explicit_U
    if (not adaptive_declined and not explicit and eigtrunc > 0
            and neig >= n
            and (eig_method == "adaptive"
                 or (eig_method == "auto" and n >= ADAPTIVE_AUTO_MIN_N))):
        why = ("eig_method='adaptive' requested"
               if eig_method == "adaptive" else
               f"auto: N={n} >= {ADAPTIVE_AUTO_MIN_N} with "
               f"eigtrunc={eigtrunc:g} > 0")
        return RouteDecision(
            "adaptive",
            f"{why} — block-Krylov head + moment-completed bounds, one "
            "fused dispatch (works under mesh and checkpoint_dir)")

    # past the adaptive check, 'adaptive' always degrades to 'auto' —
    # the documented fallback is the exact dense path, whether adaptive
    # was never eligible or declined at runtime
    method = "auto" if eig_method == "adaptive" else eig_method
    if (not mesh_present and not checkpoint_present and not explicit
            and neig >= n and method in ("auto", "full")):
        return RouteDecision(
            "fused",
            "single-chip dense fit: eigh + lambda search + solve as one "
            "device program")

    # stepwise: name the binding constraint (first match wins — the
    # order mirrors how strongly each constraint pins the route)
    if mesh_present:
        reason = ("mesh fit: stepwise eigensystem (replicated eigh vs "
                  "block-Jacobi by the measured memory crossover)")
    elif checkpoint_present:
        reason = ("checkpoint_dir: stepwise keeps the dense fallback's "
                  "save/resume bit-exact (host lambda-search control "
                  "flow on both sides)")
    elif explicit:
        which = ", ".join(
            s for s, b in (("lambda", explicit_lambda), ("L", explicit_L),
                           ("U", explicit_U)) if b)
        reason = f"explicit {which}: search shortcut, stepwise solve"
    elif neig < n:
        reason = f"neig={neig} < N={n}: truncated stepwise eigensystem"
    else:
        reason = f"eig_method={method!r}: explicit stepwise method"
    return RouteDecision("stepwise", reason)
