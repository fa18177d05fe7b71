"""Compat shim: the static analyzer lives in :mod:`repro_torch.analysis`
(port of ``repro.core.static_analysis``).

The reference's whole-function interface (``FunctionProfile`` /
``rank_functions`` / ``report``) lives on in
``repro_torch.analysis.regions``, over the ATen op stream that a
``TorchDispatchMode`` records. The reference's jaxpr-only names have no
op-stream meaning and are not faked here; their counterparts are:

  * ``analyze_jaxpr(jaxpr)`` -> :func:`analyze` ``(fn, *args)``, which
    runs ``fn`` under the recorder (meta arguments: nothing computed);
  * ``_jaxpr_cost(jaxpr)`` -> ``cost_tuple(fn_cost(fn, *args))``;
  * ``_eqn_cost(eqn)`` -> ``cost_tuple(op_cost(func, args, kwargs,
    out))`` for one dispatched ATen op (``repro_torch.analysis.costs``).

Import from ``repro_torch.analysis`` in new code.
"""
from __future__ import annotations

from repro_torch.analysis.costs import cost_tuple
from repro_torch.analysis.regions import (FunctionProfile, analyze,
                                          rank_functions, report)

__all__ = ["FunctionProfile", "analyze", "cost_tuple", "rank_functions",
           "report"]
