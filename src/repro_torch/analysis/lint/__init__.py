"""tapaslint for the port — repo-specific static analysis for TAPAS
invariants (the counterpart of ``repro.analysis.lint``), with the
captured CUDA-graph step in place of the jax trace.

Stdlib-only (``import repro_torch.analysis.lint`` loads neither torch nor
numpy): the runtime guards live in ``repro_torch.analysis.lint.runtime``
and are imported separately.  ``python -m repro_torch.analysis.lint``
is the CLI.
"""
from repro_torch.analysis.lint.framework import (Finding, ModuleContext,
                                                 Registry, Rule,
                                                 collect_files,
                                                 diff_baseline,
                                                 format_baseline,
                                                 lint_sources,
                                                 load_baseline)
from repro_torch.analysis.lint.rules import ALL_RULES, RULES_BY_CODE

__all__ = ["Finding", "ModuleContext", "Registry", "Rule", "ALL_RULES",
           "RULES_BY_CODE", "collect_files", "diff_baseline",
           "format_baseline", "lint_sources", "load_baseline"]
